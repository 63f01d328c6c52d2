"""Traffic kind `train_loop`: a closed loop of inverse-rendering steps
through `inverse.make_train_step`'s compiled step.

The target is a render of the scene with kd and emission perturbed from the
seed (kd times exp of a normal draw of `kd_sigma`, clipped to [0.02, 1];
`emissive_share` of the objects given an emission drawn from [0, 1) times
`emission_scale`), rendered once by the program's eager entry
(`integrator.render_radiance`, which the compiled one matches bit for bit)
at sample keys 0 ... spp-1 as `inverse.fit`'s callers do; training starts from the scene's own kd and
emission, with fresh samples each step (`fixed_samples=False`: step k
renders keys k*spp ...) and Adam at `learning_rate`.  Set-up builds the
step, takes its first `checked_steps` steps (the first captures its graph)
and hands the same step to the window, which steps on, reading each loss as
a training loop does.  `train_Mrays_s` counts the W*H*spp*depth slots of
every step completed in the window over the window's seconds.

Correctness: the reference renders the target again and follows the first
steps from the same start, and the program is judged by the worst relative
gap of a step's loss, of the first gradient's norm by leaf (the program's
worked out from Adam's first moment after one step, mu / (1 - b1)) and of
the norm of the parameters' change after the checked steps by leaf, each
gap of norms over the larger of the reference leaf's norm and the median
leaf's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import inputs, judge, stats
from benchmark.harness.trace import span
from benchmark.reference import tracer, training

FIELDS = ("kd", "emission")


# faults that `compared(control=...)` plants in the reference, for the readings
FAULTS = ("half_batch",)


class State:
    pass


def perturbed(arr: dict, ctx) -> dict:
    """The target's kd and emission, drawn from the seed."""
    p = ctx.workload["params"]
    rng = inputs.rng(ctx, 2)
    n = arr["kd"].shape[0]
    kd = np.clip(arr["kd"] * np.exp(p["kd_sigma"] * rng.standard_normal((n, 3))), 0.02, 1.0)
    lit = rng.random(n) < p["emissive_share"]
    em = arr["emission"] + np.where(lit, rng.random(n) * p["emission_scale"], 0.0)
    return {"kd": kd.astype(np.float32), "emission": em.astype(np.float32)}


TARGET_BATCH_RAYS = 1 << 22  # rays a batch of the target's eager render, at most


def target_image(ctx, prog: dict, spp: int, depth: int):
    """The program's render of the perturbed scene, f32[H*W, 3], through
    the eager entry (no graph is captured for this one call), its samples
    traced a few at a time (`spp_chunk`: the largest divisor of spp whose
    batch holds at most TARGET_BATCH_RAYS rays)."""
    from cpppathtracer_tpu_torch import integrator

    arr, _ = inputs.arrays(ctx)
    scene, camera = prog["scene"], prog["camera"]
    tgt = {k: torch.as_tensor(v, device=ctx.device) for k, v in perturbed(arr, ctx).items()}
    pixels = camera.width * camera.height
    chunk = max(d for d in range(1, spp + 1) if spp % d == 0 and d * pixels <= max(
        TARGET_BATCH_RAYS, pixels))
    with torch.no_grad():
        target, _, _ = integrator.render_radiance(
            scene.with_material_params({**scene.material_params(), **tgt}), camera,
            prog["sky"], spp=spp, max_depth=depth, seed=inputs.seed_word(ctx.seed),
            spp_chunk=chunk)
    return target


def checked_steps(st, ctx, steps: int, take_step, leaves):
    """Set-up's first steps through the window's own step (the first
    captures its graph): keeps the start, each step's loss and parameters
    and Adam's first moment after step 1 (`leaves(params_or_moment)` gives
    the kd and emission leaves)."""
    st.losses, st.p_hist = [], []
    for k in range(steps):
        take_step(k)
        st.losses.append(float(st.loss))
        st.p_hist.append({f: v.detach().clone() for f, v in leaves(st.params).items()})
        if k == 0:
            st.mu0 = {f: leaves(st.opt.mu)[f].detach().clone() for f in FIELDS}
            ctx.sync()
            ctx.mark("first_call")
    ctx.sync()
    ctx.mark("warm")


def setup(ctx):
    from cpppathtracer_tpu_torch import inverse

    st = State()
    prog = inputs.program_inputs(ctx)
    s, p = ctx.settings, ctx.workload["params"]
    st.w, st.h, st.spp, st.depth = s["width"], s["height"], s["spp"], ctx.config["depth"]
    scene, camera, sky = prog["scene"], prog["camera"], prog["sky"]
    ctx.mark("scene")
    target = target_image(ctx, prog, st.spp, st.depth)
    ctx.sync()
    ctx.mark("target")
    cfg = inverse.InverseConfig(spp=st.spp, max_depth=st.depth, seed=inputs.seed_word(ctx.seed),
                                learning_rate=p["learning_rate"], fields=FIELDS,
                                fixed_samples=False)
    init, step = inverse.make_train_step(camera, cfg)
    st.params, st.opt = init(scene, sky)
    st.p0 = {k: v.detach().clone() for k, v in st.params["mat"].items()}

    def take_step(k):
        st.params, st.opt, st.loss = step(st.params, st.opt, scene, sky, target, k)

    checked_steps(st, ctx, p["checked_steps"], take_step, lambda tree: tree["mat"])
    st.prog = dict(step=step, params=st.params, opt=st.opt, scene=scene, sky=sky, target=target)
    st.params = st.opt = st.loss = None
    st.next_step = p["checked_steps"]
    return st


def run(st, ctx, seconds=None, iterations=None):
    g = st.prog
    n = 0
    t0 = time.perf_counter()
    while True:
        with span("bench.step"):
            g["params"], g["opt"], loss = g["step"](g["params"], g["opt"], g["scene"], g["sky"],
                                                    g["target"], st.next_step)
        with span("bench.read_loss"):
            st.last_loss = float(loss)
        st.next_step += 1
        n += 1
        elapsed = time.perf_counter() - t0
        if (iterations is not None and n >= iterations) or (
                iterations is None and elapsed >= seconds):
            break
    slots = n * st.w * st.h * st.spp * st.depth
    return {"iterations": n, "elapsed_s": elapsed,
            "e2e": {"train_Mrays_s": stats.rate(slots, elapsed, 1e6),
                    "train_peak_GiB": ctx.memory_peak_bytes() / 2**30},
            "work": {"samples": n * st.spp, "rays": n * st.w * st.h * st.spp,
                     "pixels": st.w * st.h, "depth": st.depth}}


def release(st, ctx):
    st.prog["step"].graphs.clear()
    st.prog = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def program_readings(st, steps: int) -> dict:
    """The program's losses of its first `steps` steps, its first gradient's
    norms (from Adam's first moment) and its change after `steps` steps,
    from the leaves that `checked_steps` kept."""
    after = st.p_hist[steps - 1]
    return {"losses": st.losses[:steps],
            "grad0": {f: judge.tensor_norm(st.mu0[f]) / (1.0 - training.B1) for f in FIELDS},
            "change": {f: judge.tensor_norm(after[f] - st.p0[f]) for f in FIELDS}}


def reference_readings(ctx, dtype, steps: int, half_batch: bool = False,
                       fixed_samples: bool = False) -> dict:
    """The reference's losses, first gradient norms and change norms over
    `steps` steps (`half_batch`: the loss of the first half of the pixels
    only, the fault of a step that leaves half its batch out;
    `fixed_samples`: every step renders sample keys 0 ... spp-1, the
    target's)."""
    ref = inputs.reference_inputs(ctx, dtype)
    arr, _ = inputs.arrays(ctx)
    s = ctx.settings
    spp, depth = s["spp"], ctx.config["depth"]
    acc = tracer.acc_dtype(dtype)
    tgt = perturbed(arr, ctx)
    as_t = lambda a: torch.as_tensor(a, device=ctx.device).to(dtype).to(acc)
    params = [as_t(arr["kd"]), as_t(arr["emission"])]
    p0 = [t.clone() for t in params]
    pix = torch.arange(s["width"] * s["height"], dtype=torch.int32, device=ctx.device)
    keep = torch.arange(pix.numel() // 2, device=ctx.device) if half_batch else None
    adam = training.Adam(params, ctx.workload["params"]["learning_rate"])
    out = {"losses": [], "live_ray_bounces": 0}
    target = None
    paths = None
    for k in range(steps):
        if paths is None or not fixed_samples:
            paths, live = training.trace_samples(ref["scene"], ref["camera"], ref["sky"], pix,
                                                 inputs.seed_word(ctx.seed), spp, depth,
                                                 offset=k * spp)
            out["live_ray_bounces"] += live
        if k == 0:
            with torch.no_grad():
                target = training.image(paths, as_t(tgt["kd"]), as_t(tgt["emission"]))
        loss, gk, ge = training.loss_and_grads(paths, params[0], params[1], target, keep)
        if not fixed_samples:
            paths = None
        out["losses"].append(float(loss))
        if k == 0:
            out["grad0"] = {"kd": judge.tensor_norm(gk), "emission": judge.tensor_norm(ge)}
        params = adam.step(params, [gk, ge])
    out["change"] = {f: judge.tensor_norm(params[i] - p0[i]) for i, f in enumerate(FIELDS)}
    out["samples"] = steps * spp
    return out


def gaps(got: dict, want: dict) -> dict:
    """The worst relative gap of a step's loss, and the worst leaf's gaps of
    the first gradient's norm and of the change's norm."""
    return {"loss_rel_gap": max(stats.rel_gap(a, b) for a, b in zip(got["losses"], want["losses"])),
            "grad0_norm_gap": max(stats.leaf_gaps(got["grad0"], want["grad0"]).values()),
            "change_norm_gap": max(stats.leaf_gaps(got["change"], want["change"]).values())}


def compared(st, ctx, control=None):
    """The gaps of the program's readings, or with `control` (a dtype, or
    "half_batch") of the reference's in that precision or with half its
    batch left out, against the float32 reference's; and the steps judged."""
    steps = ctx.workload["params"]["reference_steps"]
    if getattr(st, "want", None) is None:
        st.want = reference_readings(ctx, torch.float32, steps)
    want = st.want
    if control is None:
        got = program_readings(st, steps)
    elif control == "half_batch":
        got = reference_readings(ctx, torch.float32, steps, half_batch=True)
    else:
        got = reference_readings(ctx, control, steps)
    return gaps(got, want), steps, 0


def check(st, ctx):
    got, steps, _ = compared(st, ctx)
    lim = ctx.workload["params"]["limits"]
    return judge.result([(k, v, lim[k]) for k, v in got.items()], answered=steps > 0)
