"""Traffic kind `progressive_flythrough`: a closed-loop interactive viewer.

Frames go through `renderer.ProgressiveRenderer.step` (denoiser on), each
waited for before the next, as a viewer shows each frame before it asks
for the next.  The camera flies a cycle of legs, `legs` = [[keys, frames],
...]: on every frame of a leg its keys are held and the camera takes one
step of the port's `video.fly_path` (the WASDQE semantics of the
reference's `VideoRenderer::OnKeyDown`, diagonal speed normalised):
move_left, move_forward and move_up by the keys' count difference over
its norm times `fly_step`, through `ProgressiveRenderer.move_camera`, which
restarts accumulation.  A leg with no keys is a run of still frames that
accumulate.  Every seed flies the same path from the configured camera;
the seed draws the samples, the frames kept and the pixels checked.

A frame is timed by CUDA events on the card, from before its camera op to
after its image is complete: `frame_p95_ms` is the 95th percentile over
every frame of the window; `render_Mrays_s` counts the W*H*spp*depth slots
of every frame over the window's seconds.

Correctness: `check_frames` frames are kept, drawn from the seed uniformly
over the frames rendered (a reservoir), and for each the reference flies
the camera to that frame, renders every frame of its accumulation at the
5x5 neighbourhoods of `check_pixels` pixels drawn from the seed, denoises,
clamps and mixes them, and the frame is judged like a still render.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.harness import inputs, judge, stats
from benchmark.harness.trace import span
from benchmark.reference import tracer, viewer


class State:
    pass


def fly_ops(keys: str, step: float) -> list:
    """One frame's camera ops [(op, coefficient)] with `keys` held, as
    `video.fly_path` takes them; none for no key."""
    l_r = keys.count("a") - keys.count("d")
    f_b = keys.count("w") - keys.count("s")
    u_d = keys.count("q") - keys.count("e")
    div = max(math.sqrt(float(l_r**2 + f_b**2 + u_d**2)), 1.0)
    return [(op, c / div * step)
            for op, c in (("move_left", l_r), ("move_forward", f_b), ("move_up", u_d)) if c]


class Schedule:
    """Frame f's camera ops, the flight's legs repeated from frame 0."""

    def __init__(self, params: dict):
        self.legs = [(str(keys), int(n)) for keys, n in params["legs"]]
        self.step = float(params["fly_step"])
        self.period = sum(n for _, n in self.legs)
        if self.period <= 0:
            raise ValueError("a flight of no frames")

    def ops(self, f: int) -> list:
        phase = f % self.period
        for keys, n in self.legs:
            if phase < n:
                return fly_ops(keys, self.step)
            phase -= n
        raise AssertionError(phase)

    def restart(self, f: int) -> int:
        """The frame where frame f's accumulation starts: the last frame
        that moved the camera, or frame 0."""
        for g in range(f, max(-1, f - self.period - 1), -1):
            if self.ops(g):
                return g
        return 0


def _fly(camera, ops):
    for op, c in ops:
        camera = getattr(camera, op)(c)
    return camera


def flight_poses(ctx, n: int) -> list:
    """The reference camera's pose at n frames spread evenly over one
    period of the flight from frame 0 (whose work `readings.py --counts`
    counts: a traced window is one period)."""
    cam = inputs.camera_spec(ctx)
    pose = viewer.Pose(cam["origin"], cam["look_at"], cam["view_fov"], cam["lens_radius"],
                       ctx.device)
    sch = Schedule(ctx.workload["params"])
    at = {i * sch.period // n for i in range(n)}
    out = []
    for f in range(sch.period):
        for op, c in sch.ops(f):
            pose.apply(op, c)
        if f in at:
            out.append(pose.snapshot())
    return out


def setup(ctx):
    from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig

    st = State()
    prog = inputs.program_inputs(ctx)
    s, p = ctx.settings, ctx.workload["params"]
    st.w, st.h, st.spp, st.depth = s["width"], s["height"], s["spp"], ctx.config["depth"]
    cfg = RenderConfig(width=st.w, height=st.h, max_depth=st.depth, spp_per_frame=st.spp,
                       denoise=True, seed=inputs.seed_word(ctx.seed))
    st.camera0 = prog["camera"]
    ctx.mark("scene")
    st.r = ProgressiveRenderer(prog["scene"], prog["camera"], prog["sky"], cfg)
    st.schedule = Schedule(p)
    rng = inputs.rng(ctx, 4)
    st.centres = np.sort(rng.choice(st.w * st.h, size=p["check_pixels"], replace=False))
    st.keep_rng = inputs.rng(ctx, 5)
    # warm-up: the frame graph, then each leg's camera op once; then back to the start
    st.r.step()
    ctx.sync()
    ctx.mark("first_call")
    for keys, _ in st.schedule.legs:
        ops = fly_ops(keys, st.schedule.step)
        if ops:
            st.r.move_camera(_fly, ops)
        st.r.step()
    st.r.camera = st.camera0
    st.r.refresh()
    st.frame, st.kept = 0, {}
    ctx.sync()
    ctx.mark("warm")
    return st


def _timers(ctx):
    if ctx.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        return start.record, end.record, lambda: (end.synchronize(), start.elapsed_time(end))[1]
    t = {}
    return (lambda: t.__setitem__("a", time.perf_counter()), lambda: None,
            lambda: (time.perf_counter() - t["a"]) * 1e3)


def run(st, ctx, seconds=None, iterations=None):
    """Frames from where the last call stopped (the flight and the kept
    frames go on across calls)."""
    k = ctx.workload["params"]["check_frames"]
    st.frame_ms = []
    n = 0
    t0 = time.perf_counter()
    while True:
        f = st.frame
        ops = st.schedule.ops(f)
        begin, end, wait = _timers(ctx)
        begin()
        if ops:
            with span("bench.move"):
                st.r.move_camera(_fly, ops)
        with span("bench.frame"):
            img = st.r.step()
        end()
        with span("bench.wait"):
            st.frame_ms.append(wait())
        if f < k:
            st.kept[f] = img
        else:
            j = int(st.keep_rng.integers(0, f + 1))
            if j < k:
                st.kept.pop(sorted(st.kept)[j])
                st.kept[f] = img
        st.frame += 1
        n += 1
        elapsed = time.perf_counter() - t0
        if (iterations is not None and n >= iterations) or (
                iterations is None and elapsed >= seconds):
            break
    slots = n * st.w * st.h * st.spp * st.depth
    return {"iterations": n, "elapsed_s": elapsed,
            "e2e": {"render_Mrays_s": stats.rate(slots, elapsed, 1e6),
                    "frame_p95_ms": stats.percentile(st.frame_ms, 95)},
            "work": {"samples": n * st.spp, "rays": n * st.w * st.h * st.spp,
                     "pixels": st.w * st.h, "depth": st.depth, "frames": n}}


def release(st, ctx):
    centres = torch.as_tensor(st.centres, dtype=torch.int64, device=ctx.device)
    st.kept = {f: img.reshape(-1, 3).index_select(0, centres).cpu() for f, img in st.kept.items()}
    st.r.graphs.clear()
    st.r = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_frames(ctx, st, frames, dtype):
    """The reference's display values at the check pixels of each frame."""
    arr, _ = inputs.arrays(ctx)
    cam = inputs.camera_spec(ctx)
    pose = viewer.Pose(cam["origin"], cam["look_at"], cam["view_fov"], cam["lens_radius"],
                       ctx.device)
    w, h, spp, depth = st.w, st.h, st.spp, st.depth
    centres = torch.as_tensor(st.centres, device=ctx.device)
    ys, xs = centres // w, centres % w
    pix = viewer.neighbourhood(ys, xs, h, w).to(torch.int32)
    acc = tracer.acc_dtype(dtype)
    out, done = {}, 0
    for f in sorted(frames):
        for g in range(done, f + 1):
            for op, c in st.schedule.ops(g):
                pose.apply(op, c)
        done = f + 1
        ref = inputs.reference_inputs(ctx, dtype, pose=pose.snapshot())
        r0 = st.schedule.restart(f)
        n = f - r0 + 1
        mix = torch.zeros((centres.numel(), 3), dtype=acc, device=ctx.device)
        np_ = pix.numel()
        per = max(1, (1 << 20) // (np_ * spp))
        for j0 in range(0, n, per):
            m = min(per, n - j0)
            # frame j's samples are keys j * spp ... j * spp + spp - 1, frame by frame
            keys = torch.arange(m * spp, dtype=torch.int32, device=ctx.device) + j0 * spp
            paths = tracer.trace(ref["scene"], ref["camera"], ref["sky"], pix.repeat(m * spp),
                                 keys.repeat_interleave(np_), inputs.seed_word(ctx.seed), depth)
            for i in range(m):
                sl = slice(i * spp * np_, (i * spp + 1) * np_)
                rad = paths.rad[i * spp * np_:(i + 1) * spp * np_].to(acc)
                rad = rad.reshape(spp, np_, 3).sum(0) / spp
                rad, nrm, dep = viewer.full_buffers(h, w, pix, rad, paths.first_n[sl],
                                                    paths.first_t[sl], acc)
                mix += viewer.denoise_at(rad, nrm, dep, ys, xs).clamp(0.0, 1.0)
        out[f] = mix / n
    return out


def compared(st, ctx, control=None):
    """The worst pixel_mismatch_share and rel_l1 over the kept frames, of
    the program's frames or, with `control` (a dtype), of the reference's
    in that precision, against the float32 reference; and the frames
    judged."""
    p = ctx.workload["params"]
    if getattr(st, "want", None) is None:
        st.want = reference_frames(ctx, st, list(st.kept), torch.float32)
    want = st.want
    other = None if control is None else reference_frames(ctx, st, list(st.kept), control)
    out = {"pixel_mismatch_share": 0.0, "rel_l1": 0.0}
    bad = 0
    for f in st.kept:
        got = st.kept[f].to(ctx.device) if other is None else other[f]
        one = {"pixel_mismatch_share": judge.mismatch_share(got, want[f], p["pixel_tolerance"]),
               "rel_l1": judge.rel_l1(got, want[f])}
        bad += any(v > p["limits"][k] for k, v in one.items())
        out = {k: max(out[k], v) for k, v in one.items()}
    return out, len(st.kept), bad


def check(st, ctx):
    got, judged, bad = compared(st, ctx)
    lim = ctx.workload["params"]["limits"]
    return judge.result([(k, v, lim[k]) for k, v in got.items()], answered=judged > 0,
                        failed_answers=bad)
