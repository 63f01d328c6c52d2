"""Traffic kind `grad_loop`: a closed loop of the port's compiled gradient
step, `bench.train_step_jit` (`bench.py:42-54`'s `value_and_grad`): the
loss `sum(rad^2)` of a render at seed word 0 and sample keys 0 ... spp-1 and
its gradients with respect to kd, emission and the configuration's texture
stack (the port's only entry that differentiates with respect to a stack).
A configuration without textures is refused at set-up.

The inputs are drawn from the seed: kd and every texel scaled by
exp(`sigma` N(0, 1)) and clipped to [`lo`, `hi`] (`inputs.rng` stream 2);
emission as the configuration gives it.  Set-up makes the inputs, takes the
first step (which captures its graph) and a second (a replay) and hands the
same step and inputs to the window, which steps on, reading each loss
before the next step is sent.  `train_Mrays_s` counts the W*H*spp*depth
slots of every step completed in the window over the window's seconds;
`train_peak_GiB` is the card's peak of allocated memory.

Correctness: after the window the plain reference (`reference/textured.py`)
traces the same samples at the same inputs and computes the loss and the
gradients again, and the last step of the window is judged by
`loss_rel_gap` (the loss's relative gap), `grad_norm_gap` (the worst leaf's
gap of gradient norms over the larger of the reference leaf's norm and the
median leaf's), `tex_grad_rel_l1` (sum |g - g_ref| / sum |g_ref| over the
stack's gradient: a norm alone can hide a misplaced tap) and
`mat_grad_rel_l1` (the same over kd's and emission's).

Parameters (the workload's `params`): sigma, lo, hi, limits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import inputs, judge, stats
from benchmark.harness.trace import span
from benchmark.reference import textured, tracer, training

TEXTURES = True  # the stack goes to the program's step
FAULTS = textured.FAULTS  # planted in the reference by `compared(control=...)`
LEAVES = ("kd", "emission", "tex_stack")  # the step's gradients, as `bench.train_step` keys them


class State:
    pass


def perturbed(ctx) -> dict:
    """The step's kd, emission and stack, drawn from the seed."""
    p = ctx.workload["params"]
    rng = inputs.rng(ctx, 2)
    arr, _ = inputs.arrays(ctx)
    tex = inputs.textures(ctx)
    if tex is None:
        raise ValueError(f"workloads/{ctx.cell}.json: grad_loop differentiates with respect to a "
                         f"texture stack, and configs/{ctx.config['name']}.json brings none")
    scale = lambda a: np.clip(a * np.exp(p["sigma"] * rng.standard_normal(a.shape)), p["lo"],
                              p["hi"]).astype(np.float32)
    return {"kd": scale(arr["kd"]), "emission": arr["emission"], "tex_stack": scale(tex)}


def setup(ctx):
    from cpppathtracer_tpu_torch import bench, convert

    st = State()
    prog = inputs.program_inputs(ctx)
    s = ctx.settings
    st.w, st.h, st.spp, st.depth = s["width"], s["height"], s["spp"], ctx.config["depth"]
    x = perturbed(ctx)
    scene = prog["scene"].with_material_params(
        {"kd": torch.as_tensor(x["kd"], device=ctx.device)})
    tex = convert.tex_stack_from_numpy(x["tex_stack"], device=ctx.device)
    st.args = (scene, prog["camera"], prog["sky"], st.spp, st.depth, tex)
    st.step = bench.train_step_jit
    ctx.mark("scene")
    float(st.step(*st.args)[0])
    ctx.sync()
    ctx.mark("first_call")
    float(st.step(*st.args)[0])
    ctx.sync()
    ctx.mark("warm")
    return st


def run(st, ctx, seconds=None, iterations=None):
    n = 0
    t0 = time.perf_counter()
    while True:
        with span("bench.step"):
            st.out = st.step(*st.args)
        with span("bench.read_loss"):
            st.last_loss = float(st.out[0])
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
    from cpppathtracer_tpu_torch import bench

    bench.BENCH_GRAPHS.clear()
    st.args = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(ctx, dtype, fault=None) -> dict:
    """The reference's loss and gradients in `dtype` (sums in float64 for
    float32) at the step's inputs, with `fault` planted."""
    ref = inputs.reference_inputs(ctx, dtype)
    x = perturbed(ctx)
    acc = tracer.acc_dtype(dtype)
    as_t = lambda a: torch.as_tensor(a, device=ctx.device).to(dtype).to(acc)
    s = ctx.settings
    pix = torch.arange(s["width"] * s["height"], dtype=torch.int32, device=ctx.device)
    paths, _ = training.trace_samples(ref["scene"], ref["camera"], ref["sky"], pix, 0, s["spp"],
                                      ctx.config["depth"], offset=0)
    loss, *grads = textured.loss_and_grads(ref["scene"], paths, as_t(x["kd"]),
                                           as_t(x["emission"]), as_t(x["tex_stack"]), fault)
    return {"loss": float(loss), "grads": dict(zip(LEAVES, grads))}


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared: the loss's relative gap, the worst leaf's gap
    of gradient norms, and sum |g - g_ref| / sum |g_ref| over the stack's
    gradient and over kd's and emission's together (a leaf the step did not
    return reads as zeros)."""
    want_g = want["grads"]
    g = lambda k: got["grads"].get(k, torch.zeros_like(want_g[k]))
    mats = lambda d: torch.cat([d(k).flatten().double() for k in ("kd", "emission")])
    return {"loss_rel_gap": stats.rel_gap(got["loss"], want["loss"]),
            "grad_norm_gap": max(stats.leaf_gaps(
                {k: judge.tensor_norm(g(k)) for k in LEAVES},
                {k: judge.tensor_norm(want_g[k]) for k in LEAVES}).values()),
            "tex_grad_rel_l1": judge.rel_l1(g("tex_stack"), want_g["tex_stack"]),
            "mat_grad_rel_l1": judge.rel_l1(mats(g), mats(want_g.get))}


def compared(st, ctx, control=None):
    """The numbers of the window's last step, or with `control` (a dtype,
    or one of FAULTS) of the reference in that precision or with that
    fault planted, against the float32 reference's; and the steps judged."""
    if getattr(st, "want", None) is None:
        st.want = reference_readings(ctx, torch.float32)
    if control is None:
        loss, grads = st.out
        got = {"loss": float(loss), "grads": grads}
    elif isinstance(control, str):
        got = reference_readings(ctx, torch.float32, fault=control)
    else:
        got = reference_readings(ctx, control)
    return gaps(got, st.want), 1, 0


def check(st, ctx):
    got, steps, _ = compared(st, ctx)
    lim = ctx.workload["params"]["limits"]
    return judge.result([(k, v, lim[k]) for k, v in got.items()], answered=steps > 0)
