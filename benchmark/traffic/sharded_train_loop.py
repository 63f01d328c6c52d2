"""Traffic kind `sharded_train_loop`: a closed loop of inverse-rendering
steps over a pixel-tile mesh of the cell's cards, through
`inverse.make_sharded_train_step`'s compiled step (one process drives every
card: each card's tiles forward and backward, the copies across cards, the
sums of the loss and gradients, Adam on the first card).

As `train_loop` (kd and emission, Adam at `learning_rate`, a target made
by the program from kd and emission perturbed from the seed), but over the
whole frame of the mesh, `mesh` = [rows, columns] of cards, and with the
sharded step's fixed samples (sample keys 0 ... spp-1 every step, the
target's).  `train_Mrays_s` counts the W*H*spp*depth slots of every step
over all cards; `train_peak_GiB` is the fullest card's peak.

Correctness: the reference follows the first steps over the whole frame
on the first card, and the program is judged as in `train_loop`.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import inputs, judge, registry, stats
from benchmark.harness.trace import span

TRAIN = registry.traffic("train_loop")
FIELDS = TRAIN.FIELDS


# faults that `compared(control=...)` plants in the reference, for the readings
FAULTS = ("half_batch",)


class State:
    pass


def setup(ctx):
    from cpppathtracer_tpu_torch import inverse
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh

    st = State()
    prog = inputs.program_inputs(ctx)
    s, p = ctx.settings, ctx.workload["params"]
    st.w, st.h, st.spp, st.depth = s["width"], s["height"], s["spp"], ctx.config["depth"]
    mesh = make_tile_mesh(ctx.devices, tuple(p["mesh"]))
    scene, camera, sky = prog["scene"], prog["camera"], prog["sky"]
    ctx.mark("scene")
    target = TRAIN.target_image(ctx, prog, st.spp, st.depth)
    ctx.sync()
    ctx.mark("target")
    cfg = inverse.InverseConfig(spp=st.spp, max_depth=st.depth, seed=inputs.seed_word(ctx.seed),
                                learning_rate=p["learning_rate"], fields=FIELDS)
    init, step = inverse.make_sharded_train_step(mesh, camera, cfg)
    st.params, st.opt, pix, target = init(scene, target.reshape(st.h, st.w, 3))
    st.p0 = {k: v.detach().clone() for k, v in st.params.items()}

    def take_step(_k):
        st.params, st.opt, st.loss = step(st.params, st.opt, scene, sky, pix, target)

    TRAIN.checked_steps(st, ctx, p["checked_steps"], take_step, lambda tree: tree)
    st.prog = dict(step=step, params=st.params, opt=st.opt, scene=scene, sky=sky, pix=pix,
                   target=target)
    st.params = st.opt = st.loss = None
    return st


def run(st, ctx, seconds=None, iterations=None):
    g = st.prog
    n = 0
    t0 = time.perf_counter()
    while True:
        with span("bench.step"):
            g["params"], g["opt"], loss = g["step"](g["params"], g["opt"], g["scene"], g["sky"],
                                                    g["pix"], g["target"])
        with span("bench.read_loss"):
            st.last_loss = float(loss)
        n += 1
        elapsed = time.perf_counter() - t0
        if (iterations is not None and n >= iterations) or (
                iterations is None and elapsed >= seconds):
            break
    ctx.sync()
    elapsed = time.perf_counter() - t0
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
        for d in ctx.devices:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()


program_readings = TRAIN.program_readings


def compared(st, ctx, control=None):
    """As `train_loop.compared`, with the sharded step's fixed samples."""
    steps = ctx.workload["params"]["reference_steps"]
    if getattr(st, "want", None) is None:
        st.want = TRAIN.reference_readings(ctx, torch.float32, steps, fixed_samples=True)
    if control is None:
        got = program_readings(st, steps)
    elif control == "half_batch":
        got = TRAIN.reference_readings(ctx, torch.float32, steps, half_batch=True,
                                       fixed_samples=True)
    else:
        got = TRAIN.reference_readings(ctx, control, steps, fixed_samples=True)
    return TRAIN.gaps(got, st.want), steps, 0


def check(st, ctx):
    got, steps, _ = compared(st, ctx)
    lim = ctx.workload["params"]["limits"]
    return judge.result([(k, v, lim[k]) for k, v in got.items()], answered=steps > 0)
