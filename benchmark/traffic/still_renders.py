"""Traffic kind `still_renders`: a closed loop of still renders.

Render i of the window uses the seed word (--seed + i) mod 2^32; the camera
is fixed.  Each render is `integrator.render_radiance_jit` at the cell's
resolution, samples and depth, waited for before the next is sent, as a
user who renders stills waits for each.  `render_Mrays_s` is the W*H*spp*depth
slots of every render completed in the window over the window's seconds.

Correctness: `check_pixels` pixels drawn from the seed are kept of every
render; after the window `check_renders` renders drawn from the seed are
rendered again at those pixels by the plain reference, and each is judged
by the share of its pixels whose radiance differs from the reference's by
more than `pixel_tolerance` (relative, in the largest channel).

Parameters (the workload's `params`): check_pixels, check_renders,
pixel_tolerance.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import inputs, judge, stats
from benchmark.harness.trace import span
from benchmark.reference import tracer


class State:
    pass


def setup(ctx):
    from cpppathtracer_tpu_torch import integrator

    st = State()
    st.prog = inputs.program_inputs(ctx)
    ctx.mark("scene")
    s = ctx.settings
    st.w, st.h, st.spp, st.depth = s["width"], s["height"], s["spp"], ctx.config["depth"]
    p = ctx.workload["params"]
    rng = inputs.rng(ctx, 1)
    st.check_pix = np.sort(rng.choice(st.w * st.h, size=p["check_pixels"], replace=False))
    st.pix_t = torch.as_tensor(st.check_pix, dtype=torch.int64, device=ctx.device)
    st.rng = rng
    st.render = integrator.render_radiance_jit
    st.kept, st.seeds = [], []
    # warm-up: the render's graphs are captured here, at a seed the window does not use
    _render(st, ctx, inputs.seed_word(ctx.seed - 1))
    st.kept.clear()
    ctx.sync()
    ctx.mark("first_call")
    return st


def _render(st, ctx, seed_word: int):
    scene, camera, sky = st.prog["scene"], st.prog["camera"], st.prog["sky"]
    with torch.no_grad():
        rad, _, _ = st.render(scene, camera, sky, spp=st.spp, max_depth=st.depth, seed=seed_word)
        st.kept.append(rad.index_select(0, st.pix_t))
    st.seeds.append(seed_word)


def run(st, ctx, seconds=None, iterations=None):
    st.kept, st.seeds, st.want = [], [], {}
    n = 0
    t0 = time.perf_counter()
    while True:
        with span("bench.render"):
            _render(st, ctx, inputs.seed_word(ctx.seed + n))
        with span("bench.wait"):
            ctx.sync()
        n += 1
        elapsed = time.perf_counter() - t0
        if (iterations is not None and n >= iterations) or (
                iterations is None and elapsed >= seconds):
            break
    slots = n * st.w * st.h * st.spp * st.depth
    return {"iterations": n, "elapsed_s": elapsed,
            "e2e": {"render_Mrays_s": stats.rate(slots, elapsed, 1e6)},
            "work": {"samples": n * st.spp, "rays": n * st.w * st.h * st.spp,
                     "pixels": st.w * st.h, "depth": st.depth}}


def release(st, ctx):
    from cpppathtracer_tpu_torch import integrator

    integrator.RENDER_GRAPHS.clear()
    st.kept = [k.cpu() for k in st.kept]
    st.prog = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_pixels(ctx, pix, seed_word, dtype):
    ref = inputs.reference_inputs(ctx, dtype)
    s = ctx.settings
    rad, _ = tracer.render_pixels(ref["scene"], ref["camera"], ref["sky"], pix, seed_word,
                                  s["spp"], ctx.config["depth"])
    return rad


def compared(st, ctx, control=None):
    """The worst pixel_mismatch_share and rel_l1 over `check_renders`
    renders drawn from the seed, of the program's kept pixels, or with
    `control` (a dtype) of the reference in that precision put in the
    program's place, against the float32 reference; and the renders
    judged."""
    p = ctx.workload["params"]
    n = len(st.kept)
    pick = sorted(st.rng.choice(n, size=min(n, p["check_renders"]), replace=False).tolist())
    pix = torch.as_tensor(st.check_pix, dtype=torch.int32, device=ctx.device)
    out = {"pixel_mismatch_share": 0.0, "rel_l1": 0.0}
    bad = 0
    for i in pick:
        if i not in st.want:
            st.want[i] = reference_pixels(ctx, pix, st.seeds[i], torch.float32)
        want = st.want[i]
        got = (st.kept[i].to(ctx.device) if control is None
               else reference_pixels(ctx, pix, st.seeds[i], control))
        one = {"pixel_mismatch_share": judge.mismatch_share(got, want, p["pixel_tolerance"]),
               "rel_l1": judge.rel_l1(got, want)}
        bad += any(v > p["limits"][k] for k, v in one.items())
        out = {k: max(out[k], v) for k, v in one.items()}
    return out, len(pick), bad


def check(st, ctx):
    got, judged, bad = compared(st, ctx)
    lim = ctx.workload["params"]["limits"]
    return judge.result([(k, v, lim[k]) for k, v in got.items()], answered=judged > 0,
                        failed_answers=bad)
