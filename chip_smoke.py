"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cpppathtracer_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, drives the serving path
(``render_radiance`` on ``demo_scene(0)`` at 1024^2 x 64 spp x depth 8 with
the bench camera, then 16 progressive 1280x720 frames with the denoiser),
the training path (the fwd+bwd step of bench.py:31-54 at the same size,
its gradients against the plain backward's, three steps of
``inverse.fit``) and the BVH path (``big_scene(16384)`` through the
per-bounce wavefront path at 1024^2 x 16 spp x depth 8, then 16
progressive 1280x720 frames; the dense winner launch on the same path
with POCA_BVH=0 POCA_MEGA=0), textured albedo (the megakernel's with_aux
form bitwise against its plain version unsplit, in phase A and in phase
B, the textured demo render at 1024^2 x d8 and its training step) and
training through the wavefront path (a 1024^2 x 4 spp x d8 step on
big_scene(16384) with no walk in its backward; the demo scene's
gradients under POCA_MEGA=0 against the megakernel path's) through the
kernels, times each kernel beside its bound, its plain version and a
PyTorch library yardstick (the walk also per bounce; the walk and the
backward with their registers and resident blocks per SM; the megakernel
and the dense winner launch with their registers, blocks launched, lane
searches against live ray-bounces and their floor under --fmad=false
beside the bound, in its [kernels] log lines), then the user entry points
and the tile mesh (phase 9: the command
line's render, progressive, video and invert at the presets' own sizes,
the interactive loop, a checkpoint round trip, the tiled render of the
demo scene over every card and over a virtual 2x2 mesh, the sharded loss
and gradients, a one-rank NCCL group), then the row-major body and the
stack BVH (phase 10: route A, the demo scene at 1024^2 x 4 spp x depth 8
under POCA_MEGA=0 POCA_PLANAR=0, one winner_index launch a bounce, held
against _winner_grouped_T (winner_index_plain's index) and the planar
wavefront render; route B, the demo scene without type metadata through the dense
intersect, flat and 2-D; a route A training step against the planar
wavefront's gradients; the stack BVH of big_scene(16384): native against
NumPy build, intersect_bvh against the skip-pointer walk, refit against a
rebuild), then phase 11: the megakernel's backward in its textured form
(mega_bwd(ct_aux=...)) against its plain version, the phase-B schedules
of JAX's ladder and second split against the single launch, and route A
on big_scene(16384), whose rows the dense launch stages in tiles, then
phase 12: the bench entry point (``python -m cpppathtracer_tpu_torch
bench`` and ``python bench_torch.py`` in subprocesses, and
``bench.build_bench``'s step against phase 5's) and the dense-vs-BVH
crossover harness (scripts/torch_bench_bvh.py at 1024, 2048 and 4096
objects), then phase 13: the card twins of the JAX package's video,
scaling and progressive harnesses (scripts/torch_bench_video.py,
torch_bench_scaling.py and torch_perf_progressive.py in subprocesses at
cut sizes, each output checked; ``[harness]`` lines), then phase 14: the
compiled serving calls and the denoise kernel (csrc/denoise.cu bitwise
against its plain version on the 1280x720 frame's buffers, on random
inputs at odd sizes and tile edges and on a frame with inf and NaN, at
stepwidths 0-3; ``render_radiance_jit``'s CUDA graphs bitwise against
``render_radiance`` on the demo, textured, big_scene(16384) and route A
renders; replays after in-place and value edits with no recapture; 16
compiled progressive frames bitwise against ``frame_step``, the denoiser on
and off; each replay's kernels in torch.profiler's records, no more of
them than the wrappers counted at capture; ``[compiled]`` lines), then
phase 15: the compiled training steps (``bench.train_step_jit``'s CUDA
graph of forward and backward against ``bench.train_step`` on the demo
at 1024^2 x 64 spp x d8, the textured demo at 2 spp, big_scene(16384) at
4 spp and route A at 256^2 x 1 spp x d4: losses bitwise, gradients within
the eager step's own run-to-run difference, a replay's launches the eager
step's and each kernel among torch.profiler's records; three steps of
``inverse.make_train_step``'s graph, Adam included, against the eager
step; the memory each graph holds and gives back; ``[train-compiled]``
lines), then phase 16: the seed as a device word (``mega_trace`` in both
forms and ``mega_bwd`` in both instances at seeds 0, 1, 2^31 + 5 and -3,
the word against the int and the plain version; phase 6's times beside
PR 15's), one captured render and one progressive frame graph over seeds,
the compiled video (24 orbit frames of 1024^2 x 16 spp x d8 through
``video.render_video``, PNG bytes equal to the eager loop's, and 4 frames
over a virtual 2x2 mesh), the compiled tiles (``render_image_sharded`` at
1024^2 x 4 spp x d8 tiled 1x1 and 2x2, bitwise the eager tiles, one
capture per device and tile shape) and ``inverse.fit`` with JAX's
``optimizer=`` and ``callback=`` keywords (``[seed]``, ``[video16]``,
``[tiles16]``, ``[api]`` lines); and prints:
  - the card's name and power limit (nvidia-smi);
  - one JSON line {"kernels": [...]}: beside the keys every kernel has,
    only numbers this run measured, read from the built kernels or had the
    kernels count (no floors and no counts worked out from a formula);
  - as the last line, {"ok": true, "device": {...}}.
Any failed phase raises, and the script exits non-zero.  Without a CUDA
card it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# The FP32 rate counts an FMA as two operations; the kernels are built with
# --fmad=false, so each multiply and each add is an instruction of its own:
# at most 132 SMs x 128 FP32 lanes x 1.98 GHz (boost) instructions a second.  A kernel's floor
# under that build is its operation count over this rate; the bound above
# stays the least time the card could take for the same work.
FP32_INSTR_PER_S = 132 * 128 * 1.98e9

# FP32 operations per (object, ray) pair of the winner search and per ray
# and bounce outside it, counted from csrc/winner.cuh and
# csrc/mega_trace.cu (adds, multiplies, divides, square roots, compares,
# selects and minima each count one; transcendentals count one).
OPS_SPHERE, OPS_PLATFORM, OPS_CYLINDER, OPS_RAY_BOUNCE = 33, 10, 87, 240
# The backward (csrc/mega_bwd.cuh) per ray-bounce that hit, counted the same
# way: the bounce body twice (forward sweep and reverse sweep, no winner
# search: 2 x 240) and its adjoint: shade_bwd 330 (to_world 90, the
# refraction chain 70, reflect 27, Phong 20, Schlick 20, the rest 100),
# hit_attrs_bwd 90, the carry and epilogue 45, 13 accumulations.
OPS_BWD_RAY_BOUNCE = 2 * 240 + 330 + 90 + 45 + 13

# FP32 operations per slab test and per leaf row of the BVH walk, by
# primitive type, as csrc/bvh.cuh counts them
_BVH_CUH = Path(__file__).resolve().parent / "cpppathtracer_tpu_torch" / "csrc" / "bvh.cuh"

W = H = 1024
SPP, DEPTH = 64, 8
BVH_N, BVH_SPP = 16384, 16
SUB = 1 << 16  # lanes of the kernel-vs-plain checks of the BVH phase
# World units from a silhouette edge within which float32 may decide a hit either way 840
# units from the origin: the dense search's c = |o|^2 - 2 o.c + |c|^2 - r^2 rounds terms of
# ~7e5 (ulp 0.06), so its discriminant is good to ~0.2, i.e. to 0.2 / 2r ~ 0.1 at r = 1
EDGE_TOL = 0.25
PROG_W, PROG_H = 1280, 720
FORWARD_KERNELS = ("mega_trace", "stream_compact", "stream_expand")
TEX_SPP = 4  # samples of the textured render; its training step takes 2
WF_SPP = 4  # samples of the BVH training step
TILE_SPP = 4  # samples of the tiled render (phase 9)
RM_SPP = 4  # samples of route A's render (phase 10)
RM_ROWS = 256  # rows of route B's 2-D pixel batch (phase 10)
LOSS_SIZE = 256  # width and height of the sharded loss's check (phase 9)
CAMERA = dict(origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the categories of device records, and of host calls, in torch.profiler's Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def device_records(fn, need=(), attempts=3):
    """What the device ran while fn() ran (to a synchronize; a graph's
    replay included), from the profile's Chrome trace: ({name: [device ms
    of each record]} of every kernel, memcpy and memset, [the names of each
    host call's device records, in the order of the calls, or None where
    the profiler kept none]).  The host calls are the runtime and driver
    calls of the kinds that have device records in this profile (launches,
    copies, memsets, a graph's replays), paired with them by correlation.
    The profiler loses some device records: on the H100 phase 14 kept
    181-188 of 200 denoise launches, the first ones of the profile lost,
    where scripts/torch_profiler_records.py, profiling first in its
    process, kept every one.  A profile with no
    device record at all (the profiler's tracing dropped out, seen a few
    times in some hundred profiles on the H100), or with no record of a
    kernel of `need` (a CUDA function's name, as KERNEL_OF gives it), is
    taken again, up to `attempts` profiles."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        for _ in range(attempts):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
            recs, of_call = {}, {}
            for e in events:
                if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                    recs.setdefault(e["name"], []).append(e["dur"] / 1e3)
                    of_call.setdefault(e.get("args", {}).get("correlation"), []).append(e["name"])
            host = sorted((e["args"]["correlation"], e["name"]) for e in events
                          if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {}))
            issuing = {name for c, name in host if c in of_call}
            calls = [of_call.get(c) for c, name in host if name in issuing]
            if recs and all(any(function_of(k) == n for k in recs) for n in need):
                return recs, calls
    raise AssertionError(f"torch.profiler recorded no device time, or none of {list(need)}")


def function_of(name):
    """The CUDA function of a device record's name (its template arguments
    and parameters left out)."""
    m = re.match(r"(?:void )?(\w+)[<(]", name)
    return m.group(1) if m else name


def records_per_call(calls, iters):
    """{name: device records a call} of `iters` calls that issue the same
    work, from device_records' host calls: the k-th host call of each call
    issues the same, so where the profiler lost its records in one call,
    another call's say what it ran."""
    if not calls or len(calls) % iters:
        raise AssertionError(f"{len(calls)} host calls with device work for {iters} calls")
    k = len(calls) // iters
    out = {}
    for j in range(k):
        names = next((c for c in calls[j::k] if c), None)
        if names is None:
            raise AssertionError(f"host call {j} of {k} kept no device record in {iters} calls")
        for n in names:
            out[n] = out.get(n, 0) + 1
    return out


def device_ms(fn, iters=20):
    """Device time per call of fn() over `iters` calls under torch.profiler:
    for each kernel, memset and copy by name, the mean time of its records
    times its launches a call (records_per_call), with its records kept
    and its launches in all; and the sum of those.  Returns (ms a call,
    {name: (ms a call, records kept, launches)})."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    recs, host = device_records(calls)
    per_call = records_per_call(host, iters)
    by_name = {}
    for name, times in recs.items():
        ms, n, k = by_name.get(name[:40], (0.0, 0, 0))
        by_name[name[:40]] = (ms + sum(times) / len(times) * per_call[name], n + len(times),
                              k + per_call[name] * iters)
    return (sum(ms for ms, _, _ in by_name.values()),
            {k: (round(ms, 5), n, m) for k, (ms, n, m) in by_name.items()})


def host_ms(fn, iters=50):
    """Host time per call of fn() while the device keeps up: the enqueue of
    `iters` calls on the host clock, before the closing synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / iters


def bits(t):
    """A 32-bit plane's bit pattern, for bitwise comparisons."""
    return t.view(torch.int32)


def poison_tail(planes, n):
    """Copies of 32-bit planes whose lanes [n, R) hold NaN (float planes) or
    INT_MIN (int planes)."""
    out = [p.clone() for p in planes]
    for p in out:
        bits(p)[n:] = 0x7FC00000 if p.dtype == torch.float32 else -2**31
    return out


def ops_per_ray_bounce(counts):
    n_s, n_p, n_c = counts
    return OPS_SPHERE * n_s + OPS_PLATFORM * n_p + OPS_CYLINDER * n_c + OPS_RAY_BOUNCE


def live_ray_bounces(hit_planes, active=None):
    """Ray-bounces a trace needs: a ray is traced at bounce b while every
    earlier bounce hit."""
    alive = torch.ones_like(hit_planes[0], dtype=torch.bool) if active is None else active.clone()
    total = 0
    for h in hit_planes:
        total += int(alive.sum())
        alive &= h >= 0
    return total


def compare_trace(got, ref, what):
    """Kernel vs plain outputs of one trace: hit planes equal on >= 99.9% of
    lanes; on the agreeing lanes >= 99.9% of every float output within
    1e-5 (rtol and atol) and all within 1e-3.  Returns the largest
    absolute difference of the float outputs on agreeing lanes."""
    hg, hr = torch.stack(got[6]), torch.stack(ref[6])
    agree = (hg == hr).all(0)
    frac = float(agree.float().mean())
    flat = lambda o: torch.stack([*o[0], *o[1], *o[2], o[3], *o[4], o[5]])
    fg, fr = flat(got)[:, agree], flat(ref)[:, agree]
    finite = fr.abs() < 1e29
    diff = (fg - fr).abs()
    close = torch.isclose(fg, fr, rtol=1e-5, atol=1e-5)
    max_err = float(diff[finite].max()) if finite.any() else 0.0
    log(f"[check] {what}: hit planes equal on {frac:.6f} of lanes, "
        f"{float(close.float().mean()):.6f} of values within 1e-5, max |diff| {max_err:.3e}")
    if frac < 0.999:
        raise AssertionError(f"{what}: hit planes agree on only {frac:.6f} of lanes")
    if float(close.float().mean()) < 0.999 or not torch.allclose(fg, fr, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"{what}: outputs disagree beyond tolerance")
    return max_err


def compare_bwd(got, ref, what):
    """Kernel vs plain cotangents of one sample.  ct_o and ct_d: all
    finite, and on at least 99.9% of the lanes each 3-vector within
    1e-5 + 1e-4 x its largest component (float32 cancellation leaves a
    component much smaller than its lane's others no more digits than
    that).  ct_ts and ct_trt: each field's row within a relative L2 error
    of 1e-4 (the kernel's atomics add in another order).  Returns the
    largest absolute difference."""
    shares, max_err = [], 0.0
    for g, p in ((got[2], ref[2]), (got[3], ref[3])):
        g, p = torch.stack(g), torch.stack(p)
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite ray cotangents")
        diff = (g - p).abs()
        shares.append(float((diff.amax(0) <= 1e-5 + 1e-4 * p.abs().amax(0)).float().mean()))
        max_err = max(max_err, float(diff.max()))
    rel = []
    for g, p in ((got[0], ref[0]), (got[1], ref[1])):
        rel.append(float(((g - p).norm(dim=1) / p.norm(dim=1).clamp(min=1e-30)).max()))
        max_err = max(max_err, float((g - p).abs().max()))
    log(f"[check] {what}: ct_o / ct_d lanes within 1e-4 of their scale {shares[0]:.6f} / "
        f"{shares[1]:.6f}; worst table row relative L2 ct_ts {rel[0]:.3e}, ct_trt {rel[1]:.3e}; "
        f"max |diff| {max_err:.3e}")
    if min(shares) < 0.999 or max(rel) > 1e-4:
        raise AssertionError(f"{what}: mega_bwd disagrees with its plain version")
    return max_err


def cosine_and_ratio(a, b):
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm())), float(a.norm() / b.norm())


def profile_device(fn, what):
    """Device busy share and device time by kernel of fn(), under
    torch.profiler (kernel events only: an aten op's own device time
    repeats its kernels')."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: e.device_time_total
    events.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    log(f"[profile] {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.3f}), {sum(e.count for e in events)} device ops")
    for e in events[:12]:
        log(f"[profile] {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


@contextlib.contextmanager
def plain_bwd():
    """Route the sample's backward through mega_bwd_plain."""
    from cpppathtracer_tpu_torch.ops import mega
    from cpppathtracer_tpu_torch.ops.cuda import mega_bwd_kernel

    saved = mega.mega_bwd
    mega.mega_bwd = mega_bwd_kernel.mega_bwd_plain
    try:
        yield
    finally:
        mega.mega_bwd = saved


@contextlib.contextmanager
def plain_path():
    """Route the megakernel path through the plain PyTorch versions."""
    from cpppathtracer_tpu_torch.ops import mega
    from cpppathtracer_tpu_torch.ops.cuda import compact_kernel, mega_kernel

    saved = (mega.mega_trace, mega.stream_compact, mega.stream_expand)
    mega.mega_trace = mega_kernel.mega_trace_plain
    mega.stream_compact = compact_kernel.stream_compact_plain
    mega.stream_expand = compact_kernel.stream_expand_plain
    try:
        yield
    finally:
        mega.mega_trace, mega.stream_compact, mega.stream_expand = saved


@contextlib.contextmanager
def env(**values):
    """Set environment switches (POCA_BVH, POCA_MEGA) for a block."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def record_calls(module, name, calls):
    """Keep the (args, kwargs) of every call of `module.name` in a block
    (the calls still run)."""
    real = getattr(module, name)

    def recording(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def record_bvh_rays(calls):
    """Keep a copy of the rays of every BVH walk the wavefront path
    launches (its launches still count)."""
    from cpppathtracer_tpu_torch.ops import fast

    real = fast.bvh_winner_index

    def recording(o, d, tmin, tmax, *tables, **kw):
        calls.append((tuple(c.clone() for c in o), tuple(c.clone() for c in d), tmin.clone(),
                      tmax.clone()))
        return real(o, d, tmin, tmax, *tables, **kw)

    fast.bvh_winner_index = recording
    try:
        yield
    finally:
        fast.bvh_winner_index = real


@contextlib.contextmanager
def record_rowmajor_rays(calls):
    """Keep a copy of the rays of every row-major winner launch
    (``fast.winner_index_rowmajor``; its launches still count)."""
    from cpppathtracer_tpu_torch.ops import fast
    from cpppathtracer_tpu_torch.types import Rays

    real = fast.winner_index_rowmajor

    def recording(gs, rays):
        calls.append(Rays(*(t.detach().clone() for t in (rays.origin, rays.dir, rays.tmin,
                                                          rays.tmax))))
        return real(gs, rays)

    fast.winner_index_rowmajor = recording
    try:
        yield
    finally:
        fast.winner_index_rowmajor = real


def bvh_ops():
    """csrc/bvh.cuh's FP32 operation counts: (per slab test, per leaf row
    of a sphere, platform, cylinder)."""
    text = _BVH_CUH.read_text()
    get = lambda name: int(re.search(rf"#define POCA_BVH_OPS_{name} (\d+)", text).group(1))
    return get("SLAB"), tuple(get(t) for t in ("SPHERE", "PLATFORM", "CYLINDER"))


def kernel_info(fn, *args, n):
    """The first `n` ints a kernel library's info function writes."""
    import ctypes

    info = (ctypes.c_int * n)()
    err = fn(*args, ctypes.addressof(info))
    if err:
        raise AssertionError(f"{fn.__name__}: CUDA error {err}")
    return list(info)


def mega_launch_shape(run, r, n_rep, n_pad, aux):
    """The megakernel's launch shape and the work of one sample: registers,
    local bytes, resident blocks per SM and the grid of one launch over R
    lanes (phase A's and phase B's alike), from poca_mega_info; the lane
    searches `run(stats=...)` (phase A + B) ran for a ray and the warp lane
    slots they took, as the kernel counted them.  Returns (the fields read
    or counted, for the kernels line; blocks launched a sample, 2 x the
    grid, for the log alone)."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    regs, local, per_sm, grid = kernel_info(kb.library().poca_mega_info, int(aux), r, n_rep, n_pad,
                                            n=4)
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    run(stats=stats)
    searched, slots = stats.tolist()
    return dict(registers=regs, local_bytes=local, blocks_per_sm=per_sm,
                lanes_searched=searched, lane_slots=slots), 2 * grid


def describe_shape(shape, blocks, live):
    """The log's account of a launch shape: `shape` holds registers, local
    bytes, blocks per SM, lane searches and lane slots; `blocks` the blocks
    launched; `live` the live ray-bounces."""
    return (f"{blocks} blocks launched ({shape['blocks_per_sm']} per SM, "
            f"{shape['registers']} registers, {shape['local_bytes']} local bytes a thread); "
            f"{shape['lanes_searched']} lane searches for a ray against {live} live ray-bounces "
            f"({shape['lanes_searched'] / max(live, 1):.4f}), in {shape['lane_slots']} warp lane "
            f"slots ({shape['lanes_searched'] / max(shape['lane_slots'], 1):.4f} of them busy)")


def take(ray, lanes):
    """The rays (o, d, tmin, tmax) at `lanes`, contiguous."""
    o, d, tmin, tmax = ray
    pick = lambda t: t[lanes].contiguous()
    return tuple(map(pick, o)), tuple(map(pick, d)), pick(tmin), pick(tmax)


def hit_float64(gs, ray, idx):
    """Each ray against its grouped object `idx` in float64 on the CPU:
    (t by the epilogue's hit test, object_hit_attrs_p; the distance from
    the ray to the nearest edge of the object's silhouette).  The edges
    are a sphere's outline, a cylinder's side lines (the ray's distance to
    the axis in the xz projection against r), its cap rims (the crossing
    of each cap plane against r) and the cap heights where the ray meets
    the side; a platform has none (inf)."""
    from cpppathtracer_tpu_torch.ops.planar import object_hit_attrs_p
    from cpppathtracer_tpu_torch.types import INF, PrimitiveType

    f64 = lambda t: t.detach().to("cpu", torch.float64)
    rec = f64(gs.table_s)[idx.long().cpu()].T
    o, d, tmin, tmax = ray
    (ox, oy, oz), (dx, dy, dz) = tuple(map(f64, o)), tuple(map(f64, d))
    cx, cy, cz, r, ptype = rec[0], rec[1], rec[2], rec[3], rec[6]
    t, _ = object_hit_attrs_p(ptype.to(torch.int32), (cx, cy, cz), r, rec[4], rec[5], (ox, oy, oz),
                              (dx, dy, dz), f64(tmin), f64(tmax))
    t = torch.where(t < INF, t, torch.full_like(t, INF))
    inf = torch.full_like(t, INF)
    qx, qy, qz = ox - cx, oy - cy, oz - cz

    def line_dist(qs, ds):  # distance from the centre to the ray's line; the closest t
        a = sum(v * v for v in ds)
        t_c = -sum(q * v for q, v in zip(qs, ds)) / torch.where(a == 0, torch.ones_like(a), a)
        return sum((q + t_c * v) ** 2 for q, v in zip(qs, ds)).sqrt(), t_c, a

    perp, _, _ = line_dist((qx, qy, qz), (dx, dy, dz))
    s_sph = (perp - r).abs()
    perp2, t_c, a2 = line_dist((qx, qz), (dx, dz))
    s_cyl = torch.where(a2 == 0, inf, (perp2 - r).abs())
    half = (r * r - perp2 * perp2).clamp(min=0).sqrt() / a2.sqrt()
    for y_cap in (cy + rec[5] / 2, cy - rec[5] / 2):
        tc = (y_cap - oy) / torch.where(dy == 0, torch.ones_like(dy), dy)
        rho = ((ox + tc * dx - cx) ** 2 + (oz + tc * dz - cz) ** 2).sqrt()
        s_cyl = torch.minimum(s_cyl, torch.where(dy == 0, inf, (rho - r).abs()))
        for tr in (t_c - half, t_c + half):
            s_h = torch.where(perp2 <= r, (oy + tr * dy - y_cap).abs(), inf)
            s_cyl = torch.minimum(s_cyl, s_h)
    edge = torch.where(ptype == PrimitiveType.SPHERE, s_sph,
                       torch.where(ptype == PrimitiveType.CYLINDER, s_cyl, inf))
    return t, torch.nan_to_num(edge, nan=INF)


def edge_band(gs, ray, idx):
    """Per ray, the width of the band inside grouped object `idx`'s
    silhouette edge within which float32 may decide a hit either way, for
    either search: the discriminant a (r^2 - p^2) (p the ray's distance
    from the centre, in xz for a cylinder's side; a = |d|^2, or dx^2 + dz^2
    for a cylinder) is good to delta = 4 ulps of the largest term that the
    dense search's expanded quadratic (|o|^2, 2 o.c, |c|^2 + r^2) or the
    walk's direct one (|o - c|^2) rounds, so a ray whose r - p is below
    r - sqrt(r^2 - delta / a) (~ delta / (2 a r) for a small delta; all of
    r when delta / a >= r^2) can go either way; inf for a platform.  At
    big_camera(4096), 840 units out, it is 0.125-0.25 at r = 1, where
    bvh_phase uses EDGE_TOL = 0.25; at big_camera(16384), 1,680 units out,
    1-2."""
    from cpppathtracer_tpu_torch.types import PrimitiveType

    f64 = lambda t: t.detach().to("cpu", torch.float64)
    rec = f64(gs.table_s)[idx.long().cpu()].T
    o, d = torch.stack([f64(c) for c in ray[0]]), torch.stack([f64(c) for c in ray[1]])
    c, r = rec[0:3], rec[3].abs()
    terms = torch.stack([(o * o).sum(0), 2 * (o * c).sum(0).abs(), (c * c).sum(0) + r * r,
                         ((o - c) ** 2).sum(0)]).amax(0)
    delta = 4 * 2.0 ** (torch.floor(torch.log2(terms)) - 23)
    a = torch.where(rec[6] == PrimitiveType.CYLINDER, d[0] ** 2 + d[2] ** 2, (d * d).sum(0))
    band = r - (r * r - delta / a).clamp(min=0).sqrt()
    return torch.where(rec[6] == PrimitiveType.PLATFORM, torch.full_like(band, float("inf")), band)


def loss_grads(scene, camera, sky, spp, depth, tex=None):
    """bench.py's loss, sum(rad^2), and its gradients w.r.t. kd and
    emission (and the texture stack `tex` when given), as the port's bench
    step computes them: (loss, g_kd, g_emission[, g_tex])."""
    from cpppathtracer_tpu_torch.bench import train_step

    loss, grads = train_step(scene, camera, sky, spp, depth, tex_stack=tex)
    return (loss, *grads.values())


def trace_planes(out):
    """Every plane a trace returns: the 14 float outputs, the hit planes,
    the aux planes (with_aux) and the final origin (with_o)."""
    planes = [*out[0], *out[1], *out[2], out[3], *out[4], out[5], *out[6]]
    planes += [c for pos, att in out[7] or () for c in (*pos, att)]
    return planes + (list(out[8]) if len(out) > 8 else [])


def same_bits(a, b):
    return len(a) == len(b) and all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def textured_scene(scene, dev):
    """demo_scene(0) with texture 0 on the platform, 1 on the cylinders and
    none on the spheres; a stack of two 256^2 textures made with numpy from
    fixed seeds (a checker and procedural_sky(256, 256, seed=1))."""
    import dataclasses

    from cpppathtracer_tpu_torch.ops.texture import procedural_sky
    from cpppathtracer_tpu_torch.types import PrimitiveType

    tid = torch.where(scene.prim_type == PrimitiveType.PLATFORM, 0,
                      torch.where(scene.prim_type == PrimitiveType.CYLINDER, 1, -1)).to(torch.int32)
    cells = (np.arange(256)[:, None] // 32 + np.arange(256)[None, :] // 32) % 2
    checker = np.where(cells[..., None] == 1, np.float32([0.9, 0.8, 0.3]),
                       np.float32([0.2, 0.3, 0.7])).astype(np.float32)
    tex = np.stack([checker, procedural_sky(256, 256, seed=1)])
    return dataclasses.replace(scene, tex_id=tid), torch.from_numpy(tex).to(dev)


def textured_phase(dev, scene, camera, sky, trace_args, gs, k1, time_kernels, live, floor_ms):
    """Textured albedo on the megakernel path: the with_aux form bitwise
    against its plain version (unsplit on 2^16 primaries, phase A, phase B
    with a poisoned tail) and through the split sample; the textured
    render, the unused-texture check, a profile and the training step.
    Returns the kernel row of the with_aux form (`time_kernels` times it at
    the main path's shapes; `live` live ray-bounces a sample, its
    --fmad=false floor `floor_ms`), and the arguments of the training
    step's first mega_bwd call with the step's mega_bwd launches."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.ops import mega as mega_mod
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import stream_compact
    from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import mega_trace, mega_trace_plain

    r = W * H
    counts = gs.counts
    o, d, pix, samp, seed, geom, ts, trt = trace_args

    # 1. the kernel against its plain version, every plane bitwise
    head = lambda v: tuple(c[:SUB].contiguous() for c in v)
    sub_args = (head(o), head(d), pix[:SUB].contiguous(), samp[:SUB].contiguous(), seed, geom, ts,
                trt)
    got = mega_trace(*sub_args, counts=counts, depth=DEPTH, with_aux=True)
    ref = mega_trace_plain(*sub_args, counts=counts, depth=DEPTH, with_aux=True)
    if not same_bits(trace_planes(got), trace_planes(ref)):
        raise AssertionError("mega_trace(with_aux) differs from its plain version (unsplit)")
    a_kw = dict(counts=counts, depth=2, with_o=True, with_aux=True)
    out_a = mega_trace(*trace_args, **a_kw)
    if not same_bits(trace_planes(out_a), trace_planes(mega_trace_plain(*trace_args, **a_kw))):
        raise AssertionError("mega_trace(with_aux) differs from its plain version (phase A)")
    missed_a = out_a[3]
    payload = [pix, samp, *out_a[8], *out_a[1], *out_a[2], missed_a]
    packed, offs, n_alive = stream_compact(missed_a, payload)
    n = int(n_alive[0])

    def phase_b(planes):
        args = (tuple(planes[2:5]), tuple(planes[5:8]), planes[0], planes[1], seed, geom, ts, trt)
        kw = dict(counts=counts, depth=DEPTH - 2, start_bounce=2, thru=tuple(planes[8:11]),
                  n_alive=n_alive, alive_mask=planes[11], with_aux=True)
        return args, kw

    b_args, b_kw = phase_b(packed)
    out_b = mega_trace(*b_args, **b_kw)
    same_b = same_bits(trace_planes(out_b), trace_planes(mega_trace_plain(*b_args, **b_kw)))
    p_args, p_kw = phase_b(poison_tail(packed, n))
    same_p = same_bits(trace_planes(mega_trace(*p_args, **p_kw)), trace_planes(out_b))
    # the split sample's aux planes, expanded back to their pixels, against the unsplit
    # plain trace's on every lane whose hit plane is >= 0 (others read no aux plane)
    merged = mega_mod._trace(o, d, pix, samp, seed, DEPTH, geom, ts, trt, counts, with_aux=True)
    unsplit = mega_trace_plain(*trace_args, counts=counts, depth=DEPTH, with_aux=True)
    aux_u = [c for pos, att in unsplit[7] for c in (*pos, att)]
    hits_equal = all(torch.equal(a, b) for a, b in zip(merged[6], unsplit[6]))
    aux_equal = all(torch.equal(bits(merged[7][k])[unsplit[6][k // 4] >= 0],
                                bits(aux_u[k])[unsplit[6][k // 4] >= 0]) for k in range(4 * DEPTH))
    log(f"[check] mega_trace(with_aux) bitwise equal to plain, all {4 * DEPTH} aux planes "
        f"included: unsplit on {SUB} primaries True, phase A True, phase B {same_b}, phase B with "
        f"the packed tail [{n}, {r}) poisoned {same_p}; the split sample's hit planes equal to the "
        f"unsplit plain trace's {hits_equal}, its expanded aux planes on every hit lane {aux_equal}")
    if not (same_b and same_p and hits_equal and aux_equal):
        raise AssertionError("mega_trace(with_aux) differs from its plain version or the split")

    # 2. the textured render
    tex_scene, tex = textured_scene(scene, dev)
    render = lambda s, spp: render_radiance(s, camera, sky, spp=spp, max_depth=DEPTH, seed=0,
                                            tex_stack=tex)
    with torch.no_grad():
        render(tex_scene, 1)  # warm-up
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        rad = render(tex_scene, TEX_SPP)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kb.LAUNCHES)
        want = dict(kb.LAUNCHES, mega_trace=0, mega_trace_aux=2 * TEX_SPP, stream_compact=TEX_SPP,
                    stream_expand=2 * TEX_SPP, mega_bwd=0, winner_index=0, bvh_winner_index=0)
        if launches != want:
            raise AssertionError(f"the textured render launched {launches}, expected {want}")
        if not (torch.isfinite(rad).all() and rad.shape == (r, 3)):
            raise AssertionError("the textured render is not finite or has the wrong shape")
        # every tex_id -1, the stack passed: the untextured render's radiance, but for the
        # order of the float32 sum (the split kernel adds phase A's and phase B's radiance,
        # the epilogue bounce by bounce); every term is >= 0, so within 1e-6 relative
        import dataclasses

        untex = render(dataclasses.replace(scene, tex_id=torch.full_like(scene.tex_id, -1)), 1)[0]
        rel = float(((untex - k1[0]).abs() / k1[0].abs().clamp(min=1e-30)).max())
        ok_rel = bool(((untex - k1[0]).abs() <= 1e-6 * k1[0].abs()).all())
    log(f"[texture render] demo_scene(0) textured, 1024^2 x {TEX_SPP} spp x d{DEPTH}: "
        f"{dt * 1e3:.1f} ms, {dt * 1e3 / TEX_SPP:.3f} ms/sample, launches {launches}, mean radiance "
        f"{float(rad.mean()):.5f} (untextured 1 spp {float(k1[0].mean()):.5f}); every tex_id -1 "
        f"with the stack: max relative difference to the untextured render {rel:.3e}, max |diff| "
        f"{float((untex - k1[0]).abs().max()):.3e}")
    if not ok_rel:
        raise AssertionError("the unused texture stack changed the radiance beyond 1e-6 relative")
    with torch.no_grad():
        profile_device(lambda: render(tex_scene, 4), "textured render, 4 samples")

    # 3. the textured training step: bench.py's loss, gradients for kd, emission and the
    # textures; its backward is mega_bwd's textured instance, one launch a sample, and no
    # autograd replay runs (ops/mega.py).  The first backward call's arguments are kept
    # for phase 11's check of the kernel on the step's own cotangents.
    tex_step = lambda spp: loss_grads(tex_scene, camera, sky, spp, DEPTH, tex)
    tex_step(1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    bwd_calls, replays = [], []
    t0 = time.perf_counter()
    with record_calls(mega_mod, "mega_bwd", bwd_calls), record_calls(mega_mod, "replay_vjp", replays):
        loss, g_kd, g_em, g_tex = tex_step(2)
        torch.cuda.synchronize()
    dt_t = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_launches = dict(kb.LAUNCHES)
    if step_launches["mega_trace_aux"] != 4 or step_launches["mega_bwd"] != 2 or replays:
        raise AssertionError(f"the textured step launched {step_launches} and ran the autograd "
                             f"replay {len(replays)} times (expected 2 mega_bwd launches, no replay)")
    if not all(torch.isfinite(g).all() for g in (g_kd, g_em, g_tex)) or not bool((g_tex != 0).any()):
        raise AssertionError("the textured gradients are non-finite or the texture's is zero")
    log(f"[texture train] fwd+bwd 1024^2 x 2 spp x d{DEPTH}: {dt_t * 1e3:.1f} ms/step, peak memory "
        f"{peak_gib:.2f} GiB (613.2-950.3 ms and 11.80 GiB through the autograd replay, PERF.md), "
        f"launches {step_launches}, autograd replays {len(replays)}, loss {float(loss):.6g}, |g_kd| "
        f"{float(g_kd.norm()):.6g}, |g_emission| {float(g_em.norm()):.6g}, |g_tex| "
        f"{float(g_tex.norm()):.6g} ({int((g_tex != 0).sum())} nonzero entries)")
    profile_device(lambda: tex_step(2), "textured training step, 2 spp")

    # 4. the with_aux form's time per sample (phase A + B) at these shapes
    ms, plain_ms, bound_ms, bound_by = time_kernels(
        lambda: (mega_trace(*trace_args, **a_kw), mega_trace(*b_args, **b_kw)),
        lambda: (mega_trace_plain(*trace_args, **a_kw), mega_trace_plain(*b_args, **b_kw)),
        16 * r * DEPTH)
    shape, blocks = mega_launch_shape(lambda **kw: (mega_trace(*trace_args, **a_kw, **kw),
                                                    mega_trace(*b_args, **b_kw, **kw)),
                                      r, geom.shape[0], ts.shape[1], True)
    log(f"[kernels] mega_trace (with_aux) per sample (phase A + B): {ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms, --fmad=false floor {floor_ms:.4f} ms; "
        f"{describe_shape(shape, blocks, live)}")
    return [dict(name="mega_trace (with_aux)", route="cuda",
                 source="cpppathtracer_tpu_torch/csrc/mega_trace.cu",
                 replaces="cpppathtracer_tpu/ops/pallas/mega_kernel.py:290",
                 launches=launches["mega_trace_aux"], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None, live_ray_bounces=live,
                 **shape)], (bwd_calls[0], step_launches["mega_bwd"])


def bvh_phase(dev, sky):
    """The BVH path: the walk and the dense launch against their plain
    versions, BVH vs dense renders, the big_scene(16384) render and
    progressive loop, a profile, the training step through the wavefront
    path (and the dense wavefront gradients against the megakernel's),
    and the two kernels' rows."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import bvh_winner_index, bvh_winner_index_plain
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
        WINNER_TILE_ROWS, build_geom_rows, winner_index, winner_index_plain,
    )
    from cpppathtracer_tpu_torch.ops.fast import group_scene
    from cpppathtracer_tpu_torch.ops.planar import gather_epilogue_p
    from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig
    from cpppathtracer_tpu_torch.types import INF

    r = W * H
    sub = torch.arange(0, r, r // SUB, device=dev)  # SUB lanes spread over the image

    # 1. build
    t0 = time.perf_counter()
    scene = big_scene(BVH_N, device=dev)
    build_s = time.perf_counter() - t0
    m, k = scene.bvh_dims
    log(f"[bvh] big_scene({BVH_N}): {scene.num_objects} objects {scene.type_counts}, "
        f"M = {m} nodes, K = {k}, leaf rows {tuple(scene.bvh_objs.shape)}, built in {build_s:.2f} s")
    camera = big_camera(BVH_N, W, H, device=dev)
    gs = group_scene(scene)
    tables = (gs.bvh_meta, gs.bvh_aabb, gs.bvh_objs)
    n_leaves = gs.bvh_objs.shape[0] // k
    regs, local, per_sm, in_smem = kernel_info(kb.library().poca_bvh_info, m, n_leaves, n=4)
    log(f"[bvh] walk kernel: {regs} registers, {local} local bytes a thread, {per_sm} blocks of "
        f"256 threads per SM; its layout: {gs.bvh_layout[2].shape[0]} rows in {n_leaves} leaves, "
        f"nodes and headers {32 * m + 16 * n_leaves} bytes in "
        f"{'shared memory' if in_smem else 'device memory, read through the cache'}")

    # one sample of the slice render with every bounce's rays kept (also the warm-up)
    calls = []
    with torch.no_grad(), record_bvh_rays(calls):
        render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0)
    torch.cuda.synchronize()

    # 2. the walk against its plain version on 2^16 primaries and 2^16 secondaries
    alive1 = (calls[1][0][0] != calls[0][0][0]) | (calls[1][0][1] != calls[0][0][1])
    live = alive1.nonzero().squeeze(1)
    sub2 = live[torch.linspace(0, live.numel() - 1, SUB, device=dev).long()]
    for what, ray in (("primaries", take(calls[0], sub)), ("bounce-1 rays", take(calls[1], sub2))):
        got = bvh_winner_index(*ray, *tables, leaf_size=k)
        ref = bvh_winner_index_plain(*ray, *tables, leaf_size=k)
        log(f"[check] bvh_winner_index vs plain, {SUB} {what} of big_scene({BVH_N}): "
            f"{float((got == ref).float().mean()):.6f} of lanes equal")
        if not torch.equal(got, ref):
            raise AssertionError(f"bvh_winner_index differs from its plain version ({what})")

    # 3. the dense launch against its plain version on 2^16 primaries of big_scene(2048)
    gs2 = group_scene(big_scene(2048, bvh=False, device=dev))
    cam2 = big_camera(2048, W, H, device=dev)
    pix = torch.arange(r, dtype=torch.int32, device=dev)
    samp0 = torch.zeros(r, dtype=torch.int32, device=dev)
    zero, inf = torch.zeros(r, device=dev), torch.full((r,), INF, device=dev)
    ray2 = take((*cam2.ray_gen_planar(pix, samp0, 0), zero, inf), sub)
    geom2 = build_geom_rows(gs2)
    got = winner_index(gs2.counts, *ray2, geom2)
    if not torch.equal(got, winner_index_plain(gs2.counts, *ray2, geom2)):
        raise AssertionError("winner_index differs from its plain version")
    log(f"[check] winner_index vs plain, {SUB} primaries of big_scene(2048): bitwise equal, "
        f"{float((got > 0).float().mean()):.4f} of lanes on an object other than 0")

    # 4. BVH vs dense on big_scene(4096), 1024^2 x 1 spp, depth 1 (the dense render is
    # winner_index's own path).  The camera stands 840 units from the origin, where the
    # dense search's expanded quadratic (|o|^2 - 2 o.c + |c|^2 - r^2) loses the small
    # spheres' discriminant to cancellation, and the BVH's direct form (|o - c|^2 - r^2)
    # to a lesser degree: the renders must be bitwise equal wherever the two winners
    # agree, the winners must agree on >= 99.8% of the pixels, and wherever they differ
    # the walk's winner must be the closer under the walk's own (direct) arithmetic
    # (gather_epilogue_p), and in float64 the ray must pass within EDGE_TOL of one of the
    # two winners' silhouette edges, or their t agree within 1e-4 (a tie).
    scene4 = big_scene(4096, device=dev)
    cam4 = big_camera(4096, W, H, device=dev)
    gs4 = group_scene(scene4)
    geom4 = build_geom_rows(gs4)
    with torch.no_grad():
        got = render_radiance(scene4, cam4, sky, spp=1, max_depth=1, seed=0)
        with env(POCA_BVH="0", POCA_MEGA="0"):
            kb.reset_launches()
            ref = render_radiance(scene4, cam4, sky, spp=1, max_depth=1, seed=0)
            torch.cuda.synchronize()
            dense_launches = dict(kb.LAUNCHES)
    if dense_launches["winner_index"] != 1 or dense_launches["bvh_winner_index"]:
        raise AssertionError(f"the dense wavefront render launched {dense_launches}")
    ray4 = take((*cam4.ray_gen_planar(pix, samp0, 0), zero, inf), slice(None))
    w_bvh = bvh_winner_index(*ray4, gs4.bvh_meta, gs4.bvh_aabb, gs4.bvh_objs,
                             leaf_size=gs4.bvh_dims[1])
    w_dense = winner_index(gs4.counts, *ray4, geom4)
    agree = w_bvh == w_dense
    same = [torch.equal(a[agree], b[agree]) for a, b in zip(got, ref)]
    t_of = lambda idx: gather_epilogue_p(gs4.table_s, gs4.table_r, *ray4, idx)[0]["t"]
    t_bvh, t_dense = t_of(w_bvh)[~agree], t_of(w_dense)[~agree]
    dense_missed = int((t_dense >= INF).sum())
    diff = (~agree).nonzero().squeeze(1)
    (t64_bvh, e_bvh), (t64_dense, e_dense) = (hit_float64(gs4, take(ray4, diff), w[diff])
                                              for w in (w_bvh, w_dense))
    split64 = [int(v.sum()) for v in ((t64_dense >= INF) & (t64_bvh < INF),
                                      (t64_dense > t64_bvh) & (t64_dense < INF),
                                      t64_dense == t64_bvh, t64_dense < t64_bvh)]
    near_tie = (t64_dense == t64_bvh) | ((t64_dense - t64_bvh).abs() <= 1e-4 * t64_bvh)
    edge = torch.minimum(e_bvh, e_dense)
    at_edge = ~near_tie & (edge <= EDGE_TOL)
    lost = ~near_tie & ~at_edge
    qs = torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64)
    q = [round(v, 5) for v in edge[at_edge].quantile(qs).tolist()] if at_edge.any() else []
    # the chance baseline: SUB agreeing lanes that hit a sphere or cylinder
    base = agree.nonzero().squeeze(1)[::max(1, int(agree.sum()) // SUB)]
    e_base = hit_float64(gs4, take(ray4, base), w_bvh[base])[1]
    e_base = e_base[e_base < INF]
    share = float(agree.float().mean())
    log(f"[check] big_scene(4096) 1024^2 x d1, BVH vs POCA_BVH=0 POCA_MEGA=0: winners agree on "
        f"{share:.6f} of pixels, where radiance, normal, t are bitwise "
        f"equal: {same}; of the {diff.numel()} others the dense winner is missed by the "
        f"float32 hit test on {dense_missed}, farther on {int((t_dense > t_bvh).sum()) - dense_missed}, "
        f"tied on {int((t_dense == t_bvh).sum())}; in float64 missed on {split64[0]}, farther on "
        f"{split64[1]}, tied on {split64[2]}, closer on {split64[3]}; dense launches {dense_launches}")
    lost_types = [gs4.table_s[w[diff][lost].long(), 6].tolist()[:8] for w in (w_bvh, w_dense)]
    log(f"[check] float64 on the {diff.numel()} lanes: t within 1e-4 on {int(near_tie.sum())}; "
        f"within {EDGE_TOL} of a winner's silhouette edge on {int(at_edge.sum())} (median, 90%, "
        f"max {q}; the dense winner the nearer in float64 on "
        f"{int((at_edge & (t64_dense < t64_bvh)).sum())}); neither on {int(lost.sum())} (edges "
        f"{edge[lost].tolist()[:8]}, types {lost_types}); by chance: {e_base.numel()} agreeing "
        f"sphere or cylinder hits, {float((e_base <= EDGE_TOL).double().mean()):.4f} within "
        f"{EDGE_TOL}, median {float(e_base.median()):.4f}")
    if not (all(same) and bool((t_bvh <= t_dense).all()) and share >= 0.998):
        raise AssertionError("the BVH render differs from the dense render at depth 1")
    if lost.any():
        raise AssertionError("BVH and dense winners differ on a lane that float32 rounding does not explain")

    # 5. the slice: 1024^2 x 16 spp x d8 on big_scene(16384)
    kb.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        rad, n0, t_first = render_radiance(scene, camera, sky, spp=BVH_SPP, max_depth=DEPTH, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    want = dict(kb.LAUNCHES, bvh_winner_index=BVH_SPP * DEPTH, mega_trace=0, mega_bwd=0,
                winner_index=0, stream_compact=0, stream_expand=0)
    if launches != want:
        raise AssertionError(f"the BVH render launched {launches}, expected {want}")
    if not (torch.isfinite(rad).all() and rad.shape == (r, 3) and torch.isfinite(n0).all()):
        raise AssertionError("the BVH render's output is not finite or has the wrong shape")
    rays = r * BVH_SPP * DEPTH
    log(f"[bvh render] big_scene({BVH_N}) 1024^2 x {BVH_SPP} spp x d{DEPTH}: {dt * 1e3:.1f} ms, "
        f"{dt * 1e3 / BVH_SPP:.3f} ms/sample, {rays / dt / 1e6:.1f} Mrays/s, launches {launches}, "
        f"mean radiance {float(rad.mean()):.5f}, first hits {float((t_first < INF).float().mean()):.4f}")

    # 6. progressive loop on the same scene, 1280x720, 1 spp/frame, denoised
    pcam = big_camera(BVH_N, PROG_W, PROG_H, device=dev)
    prog = ProgressiveRenderer(scene, pcam, sky, RenderConfig(width=PROG_W, height=PROG_H,
                                                              max_depth=DEPTH))
    prog.step()
    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    for _ in range(16):
        prog.step()
    frame = prog.frame()
    dt_p = time.perf_counter() - t0
    if not (np.isfinite(frame).all() and frame.shape == (PROG_H, PROG_W, 3)):
        raise AssertionError("BVH progressive frame is not finite")
    if kb.LAUNCHES["bvh_winner_index"] != 16 * DEPTH or kb.LAUNCHES["mega_trace"]:
        raise AssertionError(f"BVH progressive loop launched {dict(kb.LAUNCHES)}")
    log(f"[bvh progressive] 16 frames {PROG_W}x{PROG_H} x1 spp x d{DEPTH} + denoise: "
        f"{dt_p * 1e3 / 16:.2f} ms/frame, launches {dict(kb.LAUNCHES)}")

    # 7. where a sample's time goes
    with torch.no_grad():
        profile_device(lambda: render_radiance(scene, camera, sky, spp=2, max_depth=DEPTH, seed=0),
                       f"big_scene({BVH_N}), 2 samples")

    # 8. training through the wavefront path: bench.py's loss on big_scene(16384); the
    # backward replays each sample's saved winners, so the walk runs only in the forward
    loss_grads(scene, camera, sky, 1, DEPTH)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    t0 = time.perf_counter()
    loss, g_kd, g_em = loss_grads(scene, camera, sky, WF_SPP, DEPTH)
    torch.cuda.synchronize()
    dt_t = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_launches = dict(kb.LAUNCHES)
    want = dict(kb.LAUNCHES, bvh_winner_index=WF_SPP * DEPTH, mega_trace=0, mega_trace_aux=0,
                mega_bwd=0, winner_index=0, stream_compact=0, stream_expand=0)
    if step_launches != want:
        raise AssertionError(f"the BVH training step launched {step_launches}, expected {want}")
    for name, g in (("kd", g_kd), ("emission", g_em)):
        if not torch.isfinite(g).all() or not bool((g != 0).any()):
            raise AssertionError(f"the BVH step's {name} gradient is non-finite or all zero")
    log(f"[bvh train] fwd+bwd big_scene({BVH_N}) 1024^2 x {WF_SPP} spp x d{DEPTH}: "
        f"{dt_t * 1e3:.1f} ms/step, {r * WF_SPP * DEPTH / dt_t / 1e6:.1f} Mrays/s fwd+bwd, peak "
        f"memory {peak_gib:.2f} GiB, launches {step_launches} (the walk {WF_SPP} x {DEPTH}, none "
        f"in the backward), loss {float(loss):.6g}, |g_kd| {float(g_kd.norm()):.6g}, "
        f"|g_emission| {float(g_em.norm()):.6g}")
    profile_device(lambda: loss_grads(scene, camera, sky, 1, DEPTH), "BVH training step, 1 spp")

    # the dense wavefront path's gradients (POCA_MEGA=0, csrc/winner.cu) against the
    # megakernel path's (csrc/mega_bwd.cu) on the demo scene, 256^2 x 2 spp x d4
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.scene import demo_scene

    demo = demo_scene(0).build(device=dev)
    cam256 = Camera.make(256, 256, device=dev, **CAMERA)
    g_mega = loss_grads(demo, cam256, sky, 2, 4)
    with env(POCA_MEGA="0"):
        kb.reset_launches()
        g_wave = loss_grads(demo, cam256, sky, 2, 4)
        torch.cuda.synchronize()
        dense_step = dict(kb.LAUNCHES)
    if dense_step["winner_index"] != 2 * 4 or dense_step["mega_trace"] or dense_step["mega_bwd"]:
        raise AssertionError(f"the POCA_MEGA=0 step launched {dense_step}")
    # Both paths trace the same rays with the same arithmetic; only the order of the
    # gradient sums differs (cosine 1.00000000, norm ratios within 3e-7 of 1 on the
    # H100), so the bound (1e-5, 1e-4) sits well above those readings and far inside
    # the JAX test's 0.999 / 3%.
    agree = []
    for name, a, b in (("kd", g_mega[1], g_wave[1]), ("emission", g_mega[2], g_wave[2])):
        cos, ratio = cosine_and_ratio(b, a)
        agree.append(cos > 0.99999 and abs(ratio - 1) < 1e-4)
        log(f"[bvh train] POCA_MEGA=0 vs the megakernel path, demo_scene(0) 256^2 x 2 spp x d4, "
            f"{name} gradient: cosine {cos:.8f}, norm ratio {ratio:.8f} (launches {dense_step})")
    if not all(agree):
        raise AssertionError("the wavefront gradients disagree with the megakernel path's")

    # 9. kernel rows.  The walk per sample: the 8 per-bounce launches of sample 0 on its
    # recorded rays; the dense launch on the 1024^2 primaries of big_scene(4096).
    ops_slab, ops_row = bvh_ops()
    layout = gs.bvh_layout  # the scene's, as on the main path
    walk = lambda fn, **kw: [fn(*c, *tables, leaf_size=k, **kw) for c in calls]
    ms_bvh = time_ms(lambda: walk(bvh_winner_index, layout=layout), iters=5, warmup=1)
    t0 = time.perf_counter()
    counted = walk(bvh_winner_index_plain, with_counts=True)
    torch.cuda.synchronize()
    plain_bvh = (time.perf_counter() - t0) * 1e3
    # the kernel against its plain version on every bounce of the sample, 2^20 lanes each
    err_bvh = max(float((a - c[0]).abs().max())
                  for a, c in zip(walk(bvh_winner_index, layout=layout), counted))
    log(f"[check] bvh_winner_index vs plain, the {len(calls)} bounces of one sample of "
        f"big_scene({BVH_N}) at 1024^2: max |diff| {err_bvh}")
    if err_bvh:
        raise AssertionError("bvh_winner_index differs from its plain version on the sample's bounces")
    # each bounce's launch, and the share of paths still alive there (a path that missed
    # keeps its ray, so its origin stops changing)
    ms_bounce = [time_ms(lambda c=c: bvh_winner_index(*c, *tables, leaf_size=k, layout=layout),
                         iters=5, warmup=1) for c in calls]
    alive = [1.0] + [float(((a[0][0] != b[0][0]) | (a[0][1] != b[0][1]) | (a[0][2] != b[0][2]))
                           .float().mean()) for b, a in zip(calls, calls[1:])]
    log(f"[kernels] bvh_winner_index per bounce (ms): {[round(v, 4) for v in ms_bounce]}, sum "
        f"{sum(ms_bounce):.3f} ms (the 8 launches timed together: {ms_bvh:.3f} ms); paths alive "
        f"{[round(v, 4) for v in alive]}")

    n_slab = sum(int(c[1].sum()) for c in counted)
    n_rows = [sum(int(c[2][t].sum()) for c in counted) for t in range(3)]
    ops = ops_slab * n_slab + sum(o * n for o, n in zip(ops_row, n_rows))
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    bytes_bvh = DEPTH * (r * 4 * (8 + 1) + table_bytes)
    ops_s, bytes_s = ops / FP32_OPS_PER_S, bytes_bvh / HBM_BYTES_PER_S
    log(f"[kernels] bvh_winner_index per sample (8 launches): {ms_bvh:.3f} ms, bound "
        f"{max(ops_s, bytes_s) * 1e3:.4f} ms ({n_slab} slab tests x {ops_slab} + leaf rows "
        f"S/P/C {n_rows} x {ops_row} = {ops:.4g} ops, {ops_s * 1e3:.4f} ms; "
        f"{bytes_bvh / 1e6:.1f} MB {bytes_s * 1e3:.4f} ms); plain {plain_bvh:.1f} ms; "
        f"{n_slab / (r * DEPTH):.1f} slab tests and {sum(n_rows) / (r * DEPTH):.1f} leaf rows per ray")

    ms_w = time_ms(lambda: winner_index(gs4.counts, *ray4, geom4), iters=5, warmup=1)
    t0 = time.perf_counter()
    parts = [winner_index_plain(gs4.counts, *take(ray4, part), geom4)  # in SUB-lane parts
             for part in torch.arange(r, device=dev).split(SUB)]
    torch.cuda.synchronize()
    plain_w = (time.perf_counter() - t0) * 1e3
    err_w = float((torch.cat(parts) - w_dense).abs().max())
    log(f"[check] winner_index vs plain, 1024^2 primaries of big_scene(4096): max |diff| {err_w}")
    if err_w:
        raise AssertionError("winner_index differs from its plain version on big_scene(4096)")
    n_s, n_p, n_c = gs4.counts
    ops_w = r * (OPS_SPHERE * n_s + OPS_PLATFORM * n_p + OPS_CYLINDER * n_c)
    bytes_w = r * 4 * (8 + 1) + geom4.numel() * 4
    ops_ws, bytes_ws = ops_w / FP32_OPS_PER_S, bytes_w / HBM_BYTES_PER_S
    floor_w = ops_w / FP32_INSTR_PER_S
    regs_w, local_w, per_sm_w, grid_w = kernel_info(kb.library().poca_winner_info, r,
                                                    geom4.shape[0], WINNER_TILE_ROWS, n=4)
    # for the log: one search per ray, a ray a thread (the kernel counts no
    # lanes); the last block's threads past R run masked
    shape_w = dict(registers=regs_w, local_bytes=local_w, blocks_per_sm=per_sm_w,
                   lanes_searched=r, lane_slots=grid_w * 1024)
    log(f"[kernels] winner_index, 1024^2 primaries of big_scene(4096): {ms_w:.3f} ms, bound "
        f"{max(ops_ws, bytes_ws) * 1e3:.4f} ms ({ops_w:.4g} ops {ops_ws * 1e3:.4f} ms; "
        f"{bytes_w / 1e6:.1f} MB {bytes_ws * 1e3:.4f} ms), --fmad=false floor "
        f"{floor_w * 1e3:.4f} ms; plain {plain_w:.1f} ms; {geom4.shape[0]} rows in "
        f"{32 * geom4.shape[0]} bytes of shared memory a block; blocks of 1024 threads: "
        f"{describe_shape(shape_w, grid_w, r)}")
    by = lambda o, b: "operations" if o > b else "bytes"
    return [
        dict(name="bvh_winner_index", route="cuda", source="cpppathtracer_tpu_torch/csrc/bvh.cu",
             replaces="cpppathtracer_tpu/ops/pallas/bvh_kernel.py:234",
             launches=launches["bvh_winner_index"], max_abs_err=err_bvh, ms=ms_bvh, plain_ms=plain_bvh,
             bound_ms=max(ops_s, bytes_s) * 1e3, bound_by=by(ops_s, bytes_s), library_ms=None,
             ms_per_bounce=ms_bounce, registers=regs, blocks_per_sm=per_sm),
        dict(name="winner_index", route="cuda", source="cpppathtracer_tpu_torch/csrc/winner.cu",
             replaces="cpppathtracer_tpu/ops/pallas/intersect_kernel.py:419",
             launches=dense_launches["winner_index"], max_abs_err=err_w, ms=ms_w, plain_ms=plain_w,
             bound_ms=max(ops_ws, bytes_ws) * 1e3, bound_by=by(ops_ws, bytes_ws), library_ms=None,
             registers=regs_w, local_bytes=local_w, blocks_per_sm=per_sm_w),
    ]


def rowmajor_phase(dev, sky):
    """Phase 10, the row-major body and the stack BVH.  Route A: the demo
    scene under POCA_MEGA=0 POCA_PLANAR=0 (winner_index once a bounce from
    fast.intersect_and_gather), checked against _winner_grouped_T
    (winner_index_plain's index) and the planar wavefront render; route B: the demo
    scene without type metadata (the dense intersect, no kernel), flat and
    2-D; a training step on route A against the planar wavefront's
    gradients; the stack BVH of big_scene(16384): native and NumPy builds,
    intersect_bvh against the skip-pointer walk (#7), refit against a
    rebuild.  Returns route A's keys for the winner_index row."""
    from cpppathtracer_tpu_torch.integrator import render_radiance, render_sample
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops import bvh, fast
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import bvh_winner_index
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
        build_geom_rows, winner_index, winner_index_plain,
    )
    from cpppathtracer_tpu_torch.ops.planar import gather_epilogue_p
    from cpppathtracer_tpu_torch.types import INF
    from cpppathtracer_tpu_torch.utils import native

    r = W * H
    scene = demo_scene(0).build(device=dev)
    camera = Camera.make(W, H, device=dev, **CAMERA)
    gs = fast.group_scene(scene)
    geom = build_geom_rows(gs)
    zero_launches = {k: 0 for k in kb.LAUNCHES}

    def timed_render(spp, **switches):
        """A warm render (a 1-spp warm-up first) under `switches`:
        (outputs, seconds, launches of the timed call)."""
        with torch.no_grad(), env(**switches):
            render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0)
            torch.cuda.synchronize()
            kb.reset_launches()
            t0 = time.perf_counter()
            out = render_radiance(scene, camera, sky, spp=spp, max_depth=DEPTH, seed=0)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, dict(kb.LAUNCHES)

    # 1. route A, 1024^2 x 4 spp x d8, and the planar wavefront render beside it
    calls = []
    with torch.no_grad(), env(POCA_MEGA="0", POCA_PLANAR="0"), record_rowmajor_rays(calls):
        render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0)
    (rad_a, n_a, t_a), dt_a, launches_a = timed_render(RM_SPP, POCA_MEGA="0", POCA_PLANAR="0")
    if launches_a != dict(zero_launches, winner_index=RM_SPP * DEPTH):
        raise AssertionError(f"route A launched {launches_a}, expected {RM_SPP * DEPTH} winner_index")
    if not (torch.isfinite(rad_a).all() and rad_a.shape == (r, 3) and torch.isfinite(n_a).all()):
        raise AssertionError("route A's output is not finite or has the wrong shape")
    (rad_p, n_p, t_p), dt_p, launches_p = timed_render(RM_SPP, POCA_MEGA="0")
    share_ap = float(torch.isclose(rad_a, rad_p, rtol=0, atol=1e-4).all(-1).float().mean())
    t_same, n_same = torch.equal(t_a, t_p), torch.equal(n_a, n_p)
    log(f"[rowmajor] route A, demo_scene(0) 1024^2 x {RM_SPP} spp x d{DEPTH} under POCA_MEGA=0 "
        f"POCA_PLANAR=0: {dt_a * 1e3 / RM_SPP:.3f} ms/sample ({r * RM_SPP * DEPTH / dt_a / 1e6:.1f} "
        f"Mrays/s), launches {launches_a}; the planar wavefront (POCA_MEGA=0) "
        f"{dt_p * 1e3 / RM_SPP:.3f} ms/sample, launches {launches_p}; {share_ap:.6f} of pixels "
        f"within 1e-4 of it, mean radiance {float(rad_a.mean()):.5f} / {float(rad_p.mean()):.5f}")
    log(f"[rowmajor] route A vs planar first hits: t bitwise equal {t_same} (max |diff| "
        f"{float((t_a - t_p).abs().max()):.3g}), normals bitwise equal {n_same} (max |diff| "
        f"{float((n_a - n_p).abs().max()):.3g}; the row-major attributes divide (p - c) by the "
        f"radius, as JAX's row-major body does, the planar ones multiply by its reciprocal, as "
        f"JAX's planar body does)")
    if share_ap < 0.995:
        raise AssertionError("route A disagrees with the planar wavefront render")
    with torch.no_grad(), env(POCA_MEGA="0", POCA_PLANAR="0"):
        profile_device(lambda: render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0),
                       "route A, 1 sample")

    # 2. the launch on the recorded row-major rays of sample 0 against _winner_grouped_T, the
    # plain search whose index is winner_index_plain's: bounce 0 (primaries) and bounce 1
    for b in (0, 1):
        rays = calls[b]
        got = fast.winner_index_rowmajor(gs, rays)
        t_g, ref = fast._winner_grouped_T(gs, rays)
        n_diff = int((got != ref).sum())
        log(f"[check] winner_index on the row-major rays of bounce {b} (1024^2) against "
            f"_winner_grouped_T (winner_index_plain): differs on {n_diff} lanes, so on no exact "
            f"tie either (the kernel repeats the plain arithmetic and tie-break, so it is held "
            f"bitwise); {float((t_g < INF).float().mean()):.4f} of lanes hit")
        if n_diff:
            raise AssertionError(f"the row-major winner launch disagrees at bounce {b}")
    rays1 = calls[1]
    planes1 = fast._ray_planes(*fast._planes_of(rays1))
    ms_rm = time_ms(lambda: fast.winner_index_rowmajor(gs, rays1), iters=10)
    ms_k = time_ms(lambda: winner_index(gs.counts, *planes1, geom), iters=10)
    ms_copy = time_ms(lambda: fast._ray_planes(*fast._planes_of(rays1)), iters=10)
    plain_rm = time_ms(lambda: winner_index_plain(gs.counts, *planes1, geom), iters=2, warmup=1)
    n_s, n_p, n_c = gs.counts
    ops_rm = r * (OPS_SPHERE * n_s + OPS_PLATFORM * n_p + OPS_CYLINDER * n_c)
    bytes_rm = r * 4 * (8 + 1) + geom.numel() * 4
    ops_s, bytes_s = ops_rm / FP32_OPS_PER_S, bytes_rm / HBM_BYTES_PER_S
    bound_rm = max(ops_s, bytes_s) * 1e3
    log(f"[kernels] winner_index on route A's bounce-1 rays: {ms_rm:.4f} ms a launch with the "
        f"copy of the strided planes ({ms_copy:.4f} ms of it), the kernel alone {ms_k:.4f} ms, "
        f"plain {plain_rm:.2f} ms; bound {bound_rm:.4f} ms ({ops_rm:.4g} ops {ops_s * 1e3:.4f} ms; "
        f"{bytes_rm / 1e6:.1f} MB {bytes_s * 1e3:.4f} ms)")

    # 3. route B: the same scene without type metadata, 1024^2 x 1 spp x d8, and a 2-D batch
    bare = dataclasses.replace(scene, type_perm=(), type_counts=())
    with torch.no_grad():
        grouped, _, _ = render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kb.reset_launches()
        t0 = time.perf_counter()
        rad_b, n_b, t_b = render_radiance(bare, camera, sky, spp=1, max_depth=DEPTH, seed=0)
        torch.cuda.synchronize()
        dt_b = time.perf_counter() - t0
        launches_b = dict(kb.LAUNCHES)
        peak_b = torch.cuda.max_memory_allocated() / 2**30
        pix2 = torch.arange(RM_ROWS * W, dtype=torch.int32, device=dev)
        flat = render_sample(bare, camera, sky, pix2, 0, 0, DEPTH)
        two_d = render_sample(bare, camera, sky, pix2.reshape(RM_ROWS, W), 0, 0, DEPTH)
        profile_device(lambda: render_radiance(bare, camera, sky, spp=1, max_depth=DEPTH, seed=0),
                       "route B, 1 sample")
    if launches_b != zero_launches:
        raise AssertionError(f"route B launched {launches_b}")
    if not (torch.isfinite(rad_b).all() and rad_b.shape == (r, 3)):
        raise AssertionError("route B's output is not finite or has the wrong shape")
    shapes_ok = (two_d[0].shape == (RM_ROWS, W, 3) and two_d[1].shape == (RM_ROWS, W, 3)
                 and two_d[2].shape == (RM_ROWS, W))
    same_2d = shapes_ok and all(torch.equal(a.reshape(b.shape), b) for a, b in zip(two_d, flat))
    share_b = float(torch.isclose(rad_b, grouped, rtol=0, atol=1e-4).all(-1).float().mean())
    log(f"[rowmajor] route B, demo_scene(0) without type metadata, 1024^2 x 1 spp x d{DEPTH} "
        f"(dense intersect over {scene.num_objects} objects): {dt_b * 1e3:.1f} ms/sample, peak "
        f"memory {peak_b:.2f} GiB, launches {launches_b}; {share_b:.6f} of pixels within 1e-4 of "
        f"the grouped (megakernel) render; a {RM_ROWS}x{W} pixel batch gives shapes "
        f"{[tuple(a.shape) for a in two_d]}, equal to the flat render reshaped: {same_2d}")
    # the grouped render's search expands the quadratics (|o|^2 - 2 o.c + |c|^2 - r^2) and
    # breaks ties in the grouped order, the dense intersect does neither: some secondary
    # rays take another turn (98.2% of pixels within 1e-4 at 64^2 on the CPU)
    if not same_2d or share_b < 0.95:
        raise AssertionError("route B's 2-D batch or its agreement with the grouped render fails")

    # 4. training on route A: bench.py's loss at 256^2 x 1 spp x d4 against the planar
    # wavefront's (on the CPU at 64^2: cosine 0.99999992, norm ratios within 1e-5 of 1)
    cam256 = Camera.make(256, 256, device=dev, **CAMERA)
    grads = {}
    for name, switches in (("rowmajor", dict(POCA_MEGA="0", POCA_PLANAR="0")),
                           ("planar", dict(POCA_MEGA="0"))):
        with env(**switches):
            loss_grads(scene, cam256, sky, 1, 4)  # warm-up
            torch.cuda.synchronize()
            kb.reset_launches()
            t0 = time.perf_counter()
            grads[name] = loss_grads(scene, cam256, sky, 1, 4)
            torch.cuda.synchronize()
            log(f"[rowmajor train] {name}: fwd+bwd demo_scene(0) 256^2 x 1 spp x d4 "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms/step, launches {dict(kb.LAUNCHES)}, "
                f"loss {float(grads[name][0]):.6g}")
    agree = []
    for i, name in ((1, "kd"), (2, "emission")):
        cos, ratio = cosine_and_ratio(grads["rowmajor"][i], grads["planar"][i])
        agree.append(cos > 0.9999 and abs(ratio - 1) < 1e-3)
        log(f"[rowmajor train] route A vs the planar wavefront, {name} gradient: cosine "
            f"{cos:.8f}, norm ratio {ratio:.8f}")
    if not all(agree):
        raise AssertionError("route A's gradients disagree with the planar wavefront's")

    # 5. the stack BVH of big_scene(16384): the builds, the walk against #7, refit
    big = big_scene(BVH_N, device=dev)
    t0 = time.perf_counter()
    amin, amax = bvh.object_aabbs(bvh.scene_to_np(big))
    t_aabb = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays_np = bvh.build_bvh_numpy(amin, amax)
    t_np = time.perf_counter() - t0
    if native.available():
        t0 = time.perf_counter()
        arrays_nat = native.build_bvh(amin, amax)
        t_nat = time.perf_counter() - t0
        same = all(np.array_equal(arrays_nat[k], arrays_np[k]) for k in arrays_np)
        log(f"[stack bvh] big_scene({BVH_N}): {len(arrays_np['left'])} nodes; object AABBs "
            f"{t_aabb * 1e3:.1f} ms; native build {t_nat * 1e3:.2f} ms, NumPy build "
            f"{t_np * 1e3:.1f} ms, arrays equal {same}; build_bvh takes the native builder")
        if not same:
            raise AssertionError("the native and NumPy BVH builds differ")
    else:
        log(f"[stack bvh] big_scene({BVH_N}): the native library is unavailable, so build_bvh "
            f"takes the NumPy builder ({t_np * 1e3:.1f} ms); nothing to compare it with")
    tree = bvh.build_bvh(big)
    bcam = big_camera(BVH_N, W, H, device=dev)
    pix = torch.arange(r, dtype=torch.int32, device=dev)
    prim = bcam.ray_gen(pix, 0, 0)
    with torch.no_grad():
        hit = bvh.intersect_bvh(big, tree, prim)  # warm-up and the result
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, steps = bvh.stack_walk(big, tree, prim.origin, prim.dir, prim.tmin, prim.tmax)
        torch.cuda.synchronize()
        ms_walk = (time.perf_counter() - t0) * 1e3
        ms_stack = time_ms(lambda: bvh.intersect_bvh(big, tree, prim), iters=2, warmup=0)
        gsb = fast.group_scene(big)
        o, d = bcam.ray_gen_planar(pix, 0, 0)
        ray7 = (tuple(c.contiguous() for c in o), tuple(c.contiguous() for c in d), prim.tmin,
                prim.tmax)
        tables = (gsb.bvh_meta, gsb.bvh_aabb, gsb.bvh_objs)
        walk7 = lambda: bvh_winner_index(*ray7, *tables, leaf_size=gsb.bvh_dims[1],
                                         layout=gsb.bvh_layout)
        obj7 = gather_epilogue_p(gsb.table_s, gsb.table_r, *ray7, walk7())[0]["obj_idx"]
        ms7 = time_ms(walk7, iters=5, warmup=1)
    share7 = float((hit.obj_idx == obj7).float().mean())
    log(f"[stack bvh] intersect_bvh on the 1024^2 primaries of big_camera({BVH_N}): "
        f"{ms_stack:.1f} ms a call ({steps} steps of the lock-step loop, one host read each; the "
        f"walk alone {ms_walk:.1f} ms), the skip-pointer walk (#7) {ms7:.3f} ms; object ids equal "
        f"to #7's on {share7:.6f} of pixels ({float(hit.hit.float().mean()):.4f} hit)")
    if share7 < 0.998:
        raise AssertionError("intersect_bvh disagrees with the skip-pointer walk")
    g = torch.Generator(device=dev).manual_seed(3)
    moved = dataclasses.replace(
        big, center=big.center + (torch.rand(big.center.shape, device=dev, generator=g) - 0.5))
    t0 = time.perf_counter()
    refit = bvh.refit_bvh(tree, moved)
    t_refit = time.perf_counter() - t0
    rebuilt = bvh.build_bvh(moved)
    leaf_box = lambda t: {int(i): (a, b) for i, a, b in zip(
        t.obj_idx.tolist(), t.aabb_min.cpu().numpy(), t.aabb_max.cpu().numpy()) if i >= 0}
    boxes_r, boxes_b = leaf_box(refit), leaf_box(rebuilt)
    same_leaves = boxes_r.keys() == boxes_b.keys() and all(
        np.array_equal(boxes_r[k][0], boxes_b[k][0]) and np.array_equal(boxes_r[k][1], boxes_b[k][1])
        for k in boxes_r)
    same_root = (torch.equal(refit.aabb_min[0], rebuilt.aabb_min[0])
                 and torch.equal(refit.aabb_max[0], rebuilt.aabb_max[0]))
    sub = torch.arange(0, r, r // SUB, device=dev)
    sub_rays = type(prim)(prim.origin[sub], prim.dir[sub], prim.tmin[sub], prim.tmax[sub])
    with torch.no_grad():
        w_refit = bvh.intersect_bvh(moved, refit, sub_rays).obj_idx
        w_rebuilt = bvh.intersect_bvh(moved, rebuilt, sub_rays).obj_idx
    log(f"[stack bvh] refit_bvh after moving every object by up to 0.5: {t_refit * 1e3:.1f} ms; "
        f"each object's leaf box and the root box equal a rebuild's: {same_leaves}, {same_root}; "
        f"intersect_bvh winners on {SUB} primaries equal the rebuild's: "
        f"{torch.equal(w_refit, w_rebuilt)}")
    if not (same_leaves and same_root and torch.equal(w_refit, w_rebuilt)):
        raise AssertionError("refit_bvh disagrees with a rebuild")
    return dict(route_a_launches=launches_a["winner_index"], route_a_ms=ms_rm,
                route_a_bound_ms=bound_rm)


def entry_points_phase(dev, card, tmp):
    """Phase 9: the user entry points and the tile mesh, through the port's public
    entry points at the presets' own sizes (ROADMAP #16 and #17): the
    command line's render, progressive, video and invert, the interactive
    loop, a checkpoint round trip, the tiled render and the sharded loss,
    and a one-rank NCCL group.  Each item resets the launch counts before
    it runs and checks them after; each prints its wall time beside the
    card's name and power limit.  Files go to the directory `tmp`."""
    import io
    import logging

    from PIL import Image

    from cpppathtracer_tpu_torch import __main__ as cli
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.interactive import run as interactive_run
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.presets import PRESETS
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky
    from cpppathtracer_tpu_torch.parallel import distributed
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.parallel.render import (
        global_pixel_grid, make_sharded_loss, render_image_sharded,
    )
    from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig, to_rgb8
    from cpppathtracer_tpu_torch.utils import checkpoint
    from cpppathtracer_tpu_torch.utils.obs import get_logger
    from cpppathtracer_tpu_torch.video import orbit_path

    os.environ["POCA_LOG_DIR"] = str(tmp / "logs")  # the command line's log file
    said = []  # the command line's log lines

    class Keep(logging.Handler):
        def emit(self, record):
            said.append(record.getMessage())

    get_logger().addHandler(Keep())  # after get_logger has made its own handlers
    read = lambda p: np.asarray(Image.open(p))

    def heard(pattern):
        found = [m for m in map(re.compile(pattern).search, said) if m]
        if not found:
            raise AssertionError(f"the command line logged no line like {pattern!r}")
        return float(found[-1].group(1))

    def launched(what, expect, launches, serving=True):
        missing = [k for k in expect if not launches[k]]
        if missing or (serving and launches["mega_bwd"]):
            raise AssertionError(f"{what}: kernels {missing} not launched, or a serving path ran "
                                 f"the backward: {launches}")

    def cli_run(what, expect, *argv, serving=True):
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        cli.main(list(argv))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kb.LAUNCHES)
        launched(what, expect, launches, serving)
        log(f"[entry] {what}: command {dt * 1e3:.1f} ms wall (scene build and sky load "
            f"included), launches {launches}; {card}")

    def direct_rgb8(scene, cam, sky, spp, depth, seed):
        with torch.no_grad():
            rad, n0, t0 = render_radiance(scene, cam, sky, spp=spp, max_depth=depth, seed=seed)
        h, w = cam.height, cam.width
        return to_rgb8(denoise(rad.reshape(h, w, 3), n0.reshape(h, w, 3), t0.reshape(h, w)))

    sky_asset = cli._load_sky(None, dev)

    def preset(name):
        pre = PRESETS[name]
        scene, cam = pre.build(device=dev)
        return pre, scene, cam, f"{cam.width}x{cam.height} x {pre.spp} spp x d{pre.max_depth}"

    # 1. render hundred_objects at the preset's settings (1024^2 x 64 spp x d8): the PNG
    # equals the direct render bitwise
    pre, scene, cam, size = preset("hundred_objects")
    out = tmp / "hundred_objects.png"
    cli_run(f"render --preset hundred_objects ({size})", FORWARD_KERNELS,
            "render", "--preset", "hundred_objects", "--out", str(out))
    img = read(out)
    same = img.shape == (cam.height, cam.width, 3) and np.array_equal(
        img, direct_rgb8(scene, cam, sky_asset, pre.spp, pre.max_depth, 0))
    ms_cmd = heard(r"depth \d+ on \S+ in ([0-9.]+)s") * 1e3
    log(f"[entry] render PNG {img.shape} bitwise equal to to_rgb8(denoise(render_radiance)) "
        f"called directly: {same}; the command's own render time {ms_cmd:.1f} ms; {card}")
    if not same:
        raise AssertionError("the command line's render differs from the direct render")

    # 2. render thousand_objects (1024 objects: below the 2048 at which a scene gets BVH
    # tables, so the megakernel path) at the preset's 1024^2 x 16 spp x d8: shape only
    pre, scene, cam, size = preset("thousand_objects")
    out = tmp / "thousand_objects.png"
    cli_run(f"render --preset thousand_objects ({size}, {scene.num_objects} objects)",
            FORWARD_KERNELS, "render", "--preset", "thousand_objects", "--out", str(out))
    if read(out).shape != (cam.height, cam.width, 3):
        raise AssertionError("thousand_objects render has the wrong shape")

    # 3. progressive, the demo preset (1280x720 x d8), 16 frames
    pre, scene, cam, size = preset("demo")
    out = tmp / "progressive.png"
    cli_run(f"progressive --preset demo --frames 16 ({size} a frame)", FORWARD_KERNELS,
            "progressive", "--preset", "demo", "--frames", "16", "--out", str(out))
    if read(out).shape != (cam.height, cam.width, 3):
        raise AssertionError("progressive frame has the wrong shape")
    ms_frame = heard(r"\(([0-9.]+) ms/frame\)")
    log(f"[entry] progressive: {ms_frame:.3f} ms/frame (16 frames, the command's own clock); "
        f"{card}")

    # 4. video, material_zoo (512^2 x 16 spp x d8), 24 frames through AsyncFrameSink; frame
    # 0 equals the direct render of orbit_path(...)[0] with the same seed
    pre, scene, cam, size = preset("material_zoo")
    out = tmp / "frames"
    cli_run(f"video --preset material_zoo --frames 24 ({size})", FORWARD_KERNELS,
            "video", "--preset", "material_zoo", "--frames", "24", "--out-dir", str(out))
    names = sorted(os.listdir(out))
    if names != [f"frame_{i:05d}.png" for i in range(24)]:
        raise AssertionError(f"video wrote {names}")
    same = np.array_equal(read(out / names[0]), direct_rgb8(
        scene, orbit_path(cam, 24)[0], sky_asset, pre.spp, pre.max_depth, 0))
    ms_frame = heard(r"\(([0-9.]+) ms/frame\)")
    log(f"[entry] video: {ms_frame:.3f} ms/frame (24 frames, the command's own clock, PNG "
        f"writes included); frame 0 bitwise equal to the direct render: {same}; {card}")
    if not same:
        raise AssertionError("video frame 0 differs from the direct render")

    # 5. invert at its defaults (material_zoo, 128^2 x 4 spp x d4, 100 steps), then the
    # cornell recipe (24^2 x 1 spp x d2, 30 steps), whose loss must fall 10x
    def fitted(out_dir):
        rows = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
        return [r["loss"] for r in rows], [r["t"] for r in rows]

    out = tmp / "inverse_out"
    cli_run("invert (material_zoo, 128^2 x 4 spp x d4, 100 steps)", FORWARD_KERNELS + ("mega_bwd",),
            "invert", "--out-dir", str(out), serving=False)
    losses, stamps = fitted(out)
    ms_step = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
    log(f"[entry] invert: {ms_step:.3f} ms/step over {len(losses)} steps (metrics.jsonl "
        f"stamps), loss {losses[0]:.4e} -> {losses[-1]:.4e}; {card}")
    out = tmp / "inverse_cornell"
    cli_run("invert --preset cornell --res 24 --spp 1 --depth 2 --steps 30",
            ("mega_trace", "mega_bwd"), "invert", "--preset", "cornell", "--res", "24", "--spp", "1",
            "--depth", "2", "--steps", "30", "--out-dir", str(out), serving=False)
    losses, _ = fitted(out)
    log(f"[entry] invert cornell: loss {losses[0]:.4e} -> {losses[-1]:.4e} "
        f"({losses[0] / losses[-1]:.1f}x)")
    if not (len(losses) == 30 and losses[-1] * 10 <= losses[0]):
        raise AssertionError("the cornell fit did not lower its loss tenfold")

    # 6. the interactive loop on demo at 128x72, depth 6, driven by a scripted key list
    keys = ["w", "i", "j", "+", "r", "d", "l", "-", "q", "s"]
    _, scene, cam, _ = preset("demo")
    kb.reset_launches()
    t0 = time.perf_counter()
    screen = io.StringIO()
    frames = interactive_run(scene, cam.resize(128, 72), sky_asset, max_depth=6,
                             key_source=iter(keys), out=screen)
    dt = time.perf_counter() - t0
    launched("interactive", FORWARD_KERNELS, dict(kb.LAUNCHES))
    log(f"[entry] interactive: {frames} frames for {len(keys)} keys in {dt * 1e3:.1f} ms, "
        f"{screen.getvalue().count(chr(0x2580))} half-block cells; {card}")
    if frames != len(keys) + 1:
        raise AssertionError(f"interactive rendered {frames} frames for {len(keys)} keys")

    # 7. checkpoint round trip: 8 progressive demo frames, save, restore into a fresh
    # renderer, one more frame from each
    cfg = RenderConfig(width=cam.width, height=cam.height, max_depth=8)
    prog = ProgressiveRenderer(scene, cam, sky_asset, cfg)
    for _ in range(8):
        prog.step()
    path = str(tmp / "accumulator.npz")
    checkpoint.save(path, prog.state, {"frames": 8})
    fresh = ProgressiveRenderer(scene, cam, sky_asset, cfg)
    fresh.state, meta = checkpoint.restore(path, fresh.state)
    same = (torch.equal(prog.step(), fresh.step()) and fresh.state.sample_idx == 9
            and meta == {"frames": 8})
    log(f"[entry] checkpoint: 8 frames saved and restored, frame 9 bitwise equal: {same}")
    if not same:
        raise AssertionError("a restored accumulator did not continue bitwise")

    # 8. the tiled render of demo_scene(0), 1024^2 x 4 spp x d8, over every visible card
    # and, with one card, over a virtual 2x2 mesh on it: bitwise equal to the unsharded
    scene = demo_scene(0).build(device=dev)
    cam = Camera.make(W, H, device=dev, **CAMERA)
    sky = torch.from_numpy(procedural_sky(256, 256)).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        render_radiance(scene, cam, sky, spp=1, max_depth=DEPTH, seed=0)  # warm-up
        (rad, n0, t0_buf), ms_one = timed(lambda: render_radiance(
            scene, cam, sky, spp=TILE_SPP, max_depth=DEPTH, seed=0))
    whole = (rad.reshape(H, W, 3), n0.reshape(H, W, 3), t0_buf.reshape(H, W))
    meshes = [("every card", make_tile_mesh())]
    if torch.cuda.device_count() == 1:
        meshes.append(("virtual 2x2 on one card", make_tile_mesh([dev] * 4)))
    for what, mesh in meshes:
        # warm-up: on the card the first call captures the mesh's tile graphs
        render_image_sharded(scene, cam, sky, mesh, spp=TILE_SPP, max_depth=DEPTH, seed=0)
        kb.reset_launches()
        tiled, ms_tiled = timed(lambda: render_image_sharded(scene, cam, sky, mesh, spp=TILE_SPP,
                                                             max_depth=DEPTH, seed=0))
        launched(f"tiled render ({what})", FORWARD_KERNELS, dict(kb.LAUNCHES))
        same = all(torch.equal(a, b) for a, b in zip(tiled, whole))
        log(f"[entry] tiled render {W}x{H} x {TILE_SPP} spp x d{DEPTH}, {what} "
            f"(mesh {mesh.shape}): {ms_tiled:.1f} ms against the unsharded {ms_one:.1f} ms, "
            f"bitwise equal {same}, launches {dict(kb.LAUNCHES)}; {card}")
        if not same:
            raise AssertionError(f"the tiled render ({what}) differs from the unsharded render")

    # 9. the sharded loss and its kd / emission gradients at 256^2 x 1 spp x d4 against the
    # single-device ones (the tolerances of tests/test_inverse.py:80-81)
    mesh = meshes[-1][1]
    small = cam.resize(LOSS_SIZE, LOSS_SIZE)
    target = torch.full((LOSS_SIZE * LOSS_SIZE, 3), 0.25, device=dev)

    def leaves():
        full = scene.material_params()
        return {k: full[k].detach().clone().requires_grad_(True) for k in ("kd", "emission")}

    p1 = leaves()
    kb.reset_launches()
    rad1, _, _ = render_radiance(scene.with_material_params(p1), small, sky, spp=1, max_depth=4,
                                 seed=0)
    l1 = torch.mean((rad1 - target) ** 2)
    g1 = torch.autograd.grad(l1, list(p1.values()))
    p2 = leaves()
    pix = global_pixel_grid(small, mesh)
    l2 = make_sharded_loss(mesh, 1, 4, 0)(p2, scene, small, sky, pix,
                                          target.reshape(LOSS_SIZE, LOSS_SIZE, 3))
    g2 = torch.autograd.grad(l2, list(p2.values()))
    launched("sharded loss", ("mega_trace", "mega_bwd"), dict(kb.LAUNCHES), serving=False)
    ok = bool(torch.allclose(l2, l1, rtol=1e-5, atol=0.0)) and all(
        bool(torch.allclose(b, a, rtol=1e-4, atol=1e-7)) for a, b in zip(g1, g2))
    err = max(float((b - a).abs().max()) for a, b in zip(g1, g2))
    log(f"[entry] sharded loss over mesh {mesh.shape}: {float(l2.detach()):.8e} against "
        f"{float(l1.detach()):.8e}, gradients max |diff| {err:.3e}, within rtol 1e-5 / 1e-4: {ok}")
    if not ok:
        raise AssertionError("the sharded loss or its gradients differ from the single-device ones")

    # 10. a one-rank NCCL group: gather_frame of the tiled render equals the local frame
    distributed.initialize(f"file://{tmp / 'rendezvous'}", 1, 0)
    try:
        backend = torch.distributed.get_backend()
        gathered = distributed.gather_frame(tiled[0])
    finally:
        distributed.shutdown()
    same = gathered is not None and np.array_equal(gathered, tiled[0].cpu().numpy())
    log(f"[entry] one-rank {backend} group: gather_frame equal to the local frame {same}, "
        f"torn down {not torch.distributed.is_initialized()}")
    if not same or backend != "nccl" or torch.distributed.is_initialized():
        raise AssertionError("gather_frame through a one-rank NCCL group failed")


def textured_bwd_phase(dev, trace_args, gs, step_call, step_launches):
    """Phase 11 (a): mega_bwd's textured instance (ct_aux) against
    mega_bwd_plain(ct_aux=...) on a depth-8 textured sample of the demo
    scene at 1024^2 with random cotangents (the aux ones zero on the bounces
    that missed, as the texture epilogue gives them), then on the real
    cotangents of the textured training step's first sample (`step_call`,
    its (args, kwargs)); times it on those.  Returns its kernel row, with
    the step's `step_launches`."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd, mega_bwd_plain
    from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import mega_trace

    r = W * H
    o, d, pix, samp, seed, geom, ts, trt = trace_args
    out = mega_trace(*trace_args, counts=gs.counts, depth=DEPTH, with_aux=True)
    hits = torch.stack(out[6]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(2)
    cts = [torch.randn(r, device=dev, generator=gen) for _ in range(13)]
    ct_aux = torch.randn((4 * DEPTH, r), device=dev, generator=gen)
    ct_aux = torch.where(hits.repeat_interleave(4, 0) >= 0, ct_aux, 0.0)
    args = (o, d, pix, samp, seed, ts, trt, hits, cts)
    err_rand = compare_bwd(mega_bwd(*args, ct_aux=ct_aux), mega_bwd_plain(*args, ct_aux=ct_aux),
                           "mega_bwd(ct_aux) depth 8, 1024^2 textured primaries, random cotangents")
    s_args, s_kw = step_call
    step_aux = s_kw["ct_aux"]
    missed_aux = float(step_aux[s_args[7].repeat_interleave(4, 0) < 0].abs().max())
    err_step = compare_bwd(mega_bwd(*s_args, **s_kw), mega_bwd_plain(*s_args, **s_kw),
                           "mega_bwd(ct_aux) on the textured step's own cotangents (sample 0)")
    log(f"[check] the textured step's aux cotangents on bounces that missed: max |ct| {missed_aux} "
        f"(the kernel does not read them; the replay would)")
    if missed_aux:
        raise AssertionError("the texture epilogue gave a bounce that missed an aux cotangent")
    ms = time_ms(lambda: mega_bwd(*s_args, **s_kw), iters=10)
    plain_ms = time_ms(lambda: mega_bwd_plain(*s_args, **s_kw), iters=1, warmup=1)
    hits_s = s_args[7]
    live = int((hits_s >= 0).sum())
    # bytes: 6 ray planes, pix, samp, 13 cotangent planes, the winner planes and the
    # 4 x depth aux cotangent planes read, 6 written; operations: the untextured body's
    # per ray-bounce that hit and the aux terms' 4 adds
    n_pad = ts.shape[1]
    bytes_b = 4 * r * (6 + 2 + 13 + DEPTH + 4 * DEPTH + 6) + 4 * 2 * 17 * n_pad
    ops_s = (OPS_BWD_RAY_BOUNCE + 4) * live / FP32_OPS_PER_S
    bytes_s = bytes_b / HBM_BYTES_PER_S
    regs, local, per_sm = kernel_info(kb.library().poca_mega_bwd_info, n_pad, 1, 1, n=3)
    regs0 = kernel_info(kb.library().poca_mega_bwd_info, n_pad, 1, 0, n=3)[0]
    log(f"[kernels] mega_bwd (with_aux) per textured sample: {ms:.4f} ms, bound "
        f"{max(ops_s, bytes_s) * 1e3:.4f} ms ({live} ray-bounces that hit, {ops_s * 1e3:.4f} ms; "
        f"{bytes_b / 1e6:.1f} MB {bytes_s * 1e3:.4f} ms); plain (autograd of the replay) "
        f"{plain_ms:.1f} ms; {regs} registers ({regs0} untextured), {local} local bytes a thread, "
        f"{per_sm} resident blocks of 128 threads per SM")
    return dict(name="mega_bwd (with_aux)", route="cuda",
                source="cpppathtracer_tpu_torch/csrc/mega_bwd.cu",
                replaces="cpppathtracer_tpu/ops/pallas/mega_bwd_kernel.py:389",
                launches=step_launches, max_abs_err=max(err_rand, err_step), ms=ms,
                plain_ms=plain_ms, bound_ms=max(ops_s, bytes_s) * 1e3,
                bound_by="operations" if ops_s > bytes_s else "bytes", library_ms=None,
                registers=regs, blocks_per_sm=per_sm)


def route_a_tiled_phase(dev, sky):
    """Phase 11 (b): route A (POCA_MEGA=0 POCA_PLANAR=0) on big_scene(16384),
    whose 16,400 geometry rows the dense launch stages in three tiles, at
    1024^2 x 1 spp x d8: it renders, finite; the launch bitwise equal to
    winner_index_plain on 2^16 lanes of bounces 0 and 1; its primary
    winners against the skip-pointer walk (#7), bvh_phase's dense-vs-BVH
    rule with its edge band scaled to this camera, twice as far out
    (edge_band): equal on >= 99% of the lanes (99.49% on the H100), and
    each other lane a tie in float64 or a ray within the edge band of
    either winner's silhouette; the launch timed on the 1024^2 primaries
    beside its bound and the plain version.  Returns its kernel
    row."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.ops import fast
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import bvh_winner_index
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
        WINNER_TILE_ROWS, build_geom_rows, winner_index, winner_index_plain,
    )
    from cpppathtracer_tpu_torch.ops.planar import gather_epilogue_p

    r = W * H
    big = big_scene(BVH_N, device=dev)
    cam = big_camera(BVH_N, W, H, device=dev)
    gs = fast.group_scene(big)
    geom = build_geom_rows(gs)
    n_tiles = -(-geom.shape[0] // WINNER_TILE_ROWS)
    calls = []
    with torch.no_grad(), env(POCA_MEGA="0", POCA_PLANAR="0"):
        render_radiance(big, cam, sky, spp=1, max_depth=2, seed=0)  # warm-up
        torch.cuda.synchronize()
        kb.reset_launches()
        t0 = time.perf_counter()
        with record_rowmajor_rays(calls):
            rad, n0, t_first = render_radiance(big, cam, sky, spp=1, max_depth=DEPTH, seed=0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kb.LAUNCHES)
    if launches != dict({k: 0 for k in launches}, winner_index=DEPTH):
        raise AssertionError(f"route A on big_scene({BVH_N}) launched {launches}")
    if not (torch.isfinite(rad).all() and rad.shape == (r, 3) and torch.isfinite(n0).all()):
        raise AssertionError(f"route A on big_scene({BVH_N}) is not finite or has the wrong shape")
    log(f"[route A tiles] big_scene({BVH_N}) under POCA_MEGA=0 POCA_PLANAR=0, 1024^2 x 1 spp x "
        f"d{DEPTH}: {dt * 1e3:.1f} ms, launches {launches}, {geom.shape[0]} geometry rows in "
        f"{n_tiles} tiles of {WINNER_TILE_ROWS}, mean radiance {float(rad.mean()):.5f}, first hits "
        f"{float((t_first < 1e30).float().mean()):.4f}")
    sub = torch.arange(0, r, r // SUB, device=dev)
    planes = [fast._ray_planes(*fast._planes_of(c)) for c in calls[:2]]
    for b, ray in enumerate(planes):
        got = winner_index(gs.counts, *take(ray, sub), geom)
        ref = torch.cat([winner_index_plain(gs.counts, *take(ray, part), geom)
                         for part in sub.split(SUB // 4)])
        log(f"[check] winner_index over {n_tiles} tiles vs plain, {SUB} lanes of route A's bounce "
            f"{b} on big_scene({BVH_N}): {float((got == ref).float().mean()):.6f} equal, "
            f"{float((got > 0).float().mean()):.4f} on an object other than 0")
        if not torch.equal(got, ref):
            raise AssertionError(f"the tiled winner_index differs from its plain version at bounce {b}")
    w_a = winner_index(gs.counts, *planes[0], geom)
    o, d = cam.ray_gen_planar(torch.arange(r, dtype=torch.int32, device=dev), 0, 0)
    w7 = bvh_winner_index(tuple(c.contiguous() for c in o), tuple(c.contiguous() for c in d),
                          planes[0][2], planes[0][3], gs.bvh_meta, gs.bvh_aabb, gs.bvh_objs,
                          leaf_size=gs.bvh_dims[1], layout=gs.bvh_layout)
    share = float((w_a == w7).float().mean())
    diff = (w_a != w7).nonzero().squeeze(1)
    ray_d = take(planes[0], diff)
    (t64_7, e_7), (t64_a, e_a) = (hit_float64(gs, ray_d, w[diff]) for w in (w7, w_a))
    tie = (t64_a == t64_7) | ((t64_a - t64_7).abs() <= 1e-4 * t64_7)
    band_7, band_a = edge_band(gs, ray_d, w7[diff]), edge_band(gs, ray_d, w_a[diff])
    lost = ~tie & (e_7 > band_7) & (e_a > band_a)
    rel = torch.minimum(e_7 / band_7, e_a / band_a)[~tie]
    quant = lambda v: [round(x, 5) for x in v.quantile(
        torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64)).tolist()] if v.numel() else []
    log(f"[check] route A's primary winners on big_scene({BVH_N}) against the skip-pointer walk "
        f"(#7): equal on {share:.6f} of 1024^2 lanes; of the {diff.numel()} others, float64 ties "
        f"{int(tie.sum())}, the dense winner the nearer in float64 on "
        f"{int((t64_a < t64_7).sum())}; distance to the nearer silhouette edge (median, 90%, max) "
        f"{quant(torch.minimum(e_7, e_a)[~tie])}, as a share of its edge band "
        f"{quant(rel)} (bands {quant(torch.minimum(band_7, band_a)[~tie])}); outside: "
        f"{int(lost.sum())}")
    t32 = lambda w: gather_epilogue_p(gs.table_s, gs.table_r, *ray_d, w[diff])[0]["t"]
    rec = lambda w: gs.table_s[w[diff].long()]
    for k in lost.nonzero().squeeze(1).tolist()[:8]:
        log(f"[check]   outside its band: lane {int(diff[k])}, ray o {[float(c[k]) for c in ray_d[0]]} "
            f"d {[float(c[k]) for c in ray_d[1]]}; walk winner {int(w7[diff[k]])} (type "
            f"{int(rec(w7)[k, 6])}, centre {rec(w7)[k, 0:3].tolist()}, r {float(rec(w7)[k, 3])}, "
            f"h {float(rec(w7)[k, 5])}) t32 {float(t32(w7)[k])} t64 {float(t64_7[k])} edge "
            f"{float(e_7[k])} band {float(band_7[k])}; dense winner {int(w_a[diff[k]])} (type "
            f"{int(rec(w_a)[k, 6])}, centre {rec(w_a)[k, 0:3].tolist()}, r {float(rec(w_a)[k, 3])}, "
            f"h {float(rec(w_a)[k, 5])}) t32 {float(t32(w_a)[k])} t64 {float(t64_a[k])} edge "
            f"{float(e_a[k])} band {float(band_a[k])}")
    if share < 0.99 or lost.any():
        raise AssertionError("route A's tiled winners disagree with the BVH walk beyond rounding")
    ms = time_ms(lambda: winner_index(gs.counts, *planes[0], geom), iters=3, warmup=1)
    t0 = time.perf_counter()
    for part in torch.arange(r, device=dev).split(SUB // 2):
        winner_index_plain(gs.counts, *take(planes[0], part), geom)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_s, n_p, n_c = gs.counts
    ops = r * (OPS_SPHERE * n_s + OPS_PLATFORM * n_p + OPS_CYLINDER * n_c)
    bytes_w = r * 4 * (8 + 1) + geom.numel() * 4
    ops_s, bytes_s = ops / FP32_OPS_PER_S, bytes_w / HBM_BYTES_PER_S
    regs, local, per_sm, grid = kernel_info(kb.library().poca_winner_info, r, geom.shape[0],
                                            WINNER_TILE_ROWS, n=4)
    log(f"[kernels] winner_index over {n_tiles} tiles, the 1024^2 primaries of route A on "
        f"big_scene({BVH_N}): {ms:.3f} ms a launch, bound {max(ops_s, bytes_s) * 1e3:.4f} ms "
        f"({ops:.4g} ops {ops_s * 1e3:.4f} ms; {bytes_w / 1e6:.1f} MB {bytes_s * 1e3:.4f} ms), "
        f"--fmad=false floor {ops / FP32_INSTR_PER_S * 1e3:.4f} ms; plain {plain_ms:.1f} ms (in "
        f"{SUB // 2}-lane parts); {regs} registers, {local} local bytes a thread, {per_sm} blocks "
        f"of 1024 threads per SM, {grid} blocks")
    return dict(name="winner_index (row tiles)", route="cuda",
                source="cpppathtracer_tpu_torch/csrc/winner.cu",
                replaces="cpppathtracer_tpu/ops/pallas/intersect_kernel.py:446",
                launches=launches["winner_index"], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=max(ops_s, bytes_s) * 1e3,
                bound_by="operations" if ops_s > bytes_s else "bytes", library_ms=None,
                registers=regs, local_bytes=local, blocks_per_sm=per_sm)


def ladder_phase(dev, scene, camera, sky):
    """Phase 11 (c): the JAX package's static-prefix ladder and second split
    of phase B (ops/mega.py, POCA_MEGA_LADDER / POCA_MEGA_SPLIT2 /
    POCA_MEGA_PREFIX2) against the single phase-B launch, on the demo scene
    at 1024^2 x d8: one sample of each schedule and the unsplit trace
    (POCA_MEGA_SPLIT=0) through mega_sample: hit planes, missed, first_n and
    first_t bitwise equal, radiance within 5e-7 absolute and relative
    (tests/test_mega.py:327); PREFIX2 bitwise equal to the second split,
    the ladder alone to the single launch; device ms per sample
    (torch.profiler) and launches of each, and the 1024^2 x 4 spp x d8
    render's wall time; the card's default (ops/mega.py::_CARD_LADDER) may
    be no more than 5% slower in device time than the other schedule."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.ops import mega
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.fast import group_scene

    r = W * H
    gs = group_scene(scene)
    pix = torch.arange(r, dtype=torch.int32, device=dev)
    schedules = {
        "unsplit": dict(POCA_MEGA_SPLIT="0"),
        "one launch": dict(POCA_MEGA_LADDER="0"),
        "ladder": dict(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="0"),
        "ladder + split2": dict(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1"),
        "prefix2": dict(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1", POCA_MEGA_PREFIX2="1"),
    }
    sample = lambda: mega.mega_sample(gs, camera, pix, 0, 0, DEPTH)
    planes = lambda s: [*s[0], *s[1], *s[2], s[3], *s[4], s[5], *s[6]]
    out, stats = {}, {}
    for name, switches in schedules.items():
        with torch.no_grad(), env(**switches):
            kb.reset_launches()
            out[name] = sample()
            torch.cuda.synchronize()
            launches = {k: v for k, v in kb.LAUNCHES.items() if v}
            dev_ms, by_kernel = device_ms(sample, iters=10)
            ms = time_ms(sample, iters=10)
            render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_radiance(scene, camera, sky, spp=4, max_depth=DEPTH, seed=0)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 4
        stats[name] = dev_ms
        log(f"[split2] {name} ({switches}): one 1024^2 x d{DEPTH} sample, device {dev_ms:.4f} ms "
            f"(torch.profiler; ms a call, records kept and launches of 10 calls by name {by_kernel}), {ms:.4f} ms "
            f"by CUDA events, launches {launches}; "
            f"the 4-spp render {wall:.3f} ms/sample wall")
    ref = out["unsplit"]
    paths = lambda s: [s[3], *s[4], s[5], *s[6]]
    same_paths = {n: all(torch.equal(bits(a), bits(b)) for a, b in zip(paths(s), paths(ref)))
                  for n, s in out.items()}
    rad_err = {n: max(float(((a - b).abs() / (5e-7 + 5e-7 * b.abs())).max()) for a, b in
                      zip(s[0], ref[0])) for n, s in out.items()}
    same_pre = same_bits(planes(out["prefix2"]), planes(out["ladder + split2"]))
    same_lad = same_bits(planes(out["ladder"]), planes(out["one launch"]))
    log(f"[check] against the unsplit trace: paths bitwise {same_paths}; radiance's largest "
        f"|diff| / (5e-7 + 5e-7 |x|) {rad_err}; PREFIX2 bitwise equal to the second split "
        f"{same_pre}; the ladder alone bitwise equal to the single launch {same_lad}")
    if not (all(same_paths.values()) and max(rad_err.values()) <= 1 and same_pre and same_lad):
        raise AssertionError("the ladder or the second split changed a path or the radiance")
    default = "ladder + split2" if mega._CARD_LADDER else "one launch"
    other = "one launch" if mega._CARD_LADDER else "ladder + split2"
    faster = min((default, other), key=stats.get)
    log(f"[split2] device ms per sample: the single phase-B launch {stats['one launch']:.4f}, the "
        f"ladder and second split {stats['ladder + split2']:.4f}; faster in this run: {faster}; "
        f"the card's default: {default}")
    if stats[default] > 1.05 * stats[other]:
        raise AssertionError(f"the card's default schedule ({default}) is more than 5% slower "
                             f"than {other}")


def same_fields(a, b):
    """Every field of two dataclasses equal, tensors bitwise."""
    return all(torch.equal(bits(x), bits(y)) if isinstance(x, torch.Tensor) else x == y
               for x, y in ((getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)))


def bench_phase(dev, card, scene, camera, sky, step_ref):
    """Phase 12: the port's bench entry point and the crossover harness.
    (a) ``python -m cpppathtracer_tpu_torch bench`` and ``python
    bench_torch.py`` in subprocesses: rc 0, exactly one stdout line, JSON
    with metric / value / unit / device and no vs_baseline, and value equal
    to 1024^2 x 64 x 8 over the mean timed step that its stderr prints,
    within that print's rounding.  (b) In-process,
    ``bench.build_bench(1024, 1024, 64, 8, "cuda")``: its scene, camera and
    sky bitwise equal to phase 5's, its step (compiled on the card: the
    first call captures it, and a replay is timed) launching those of
    the training step, its loss bitwise equal to phase 5's ``loss_grads``
    (`step_ref`) and the kd and emission gradients within a relative L2
    error of 1e-4 (mega_bwd's float atomics add the table cotangents in
    another order on every run, so they are held as compare_bwd holds
    table rows; whether they came out bitwise is logged).  (c) The step's
    ms, M rays/s and peak memory on a [bench] line.  (d)
    ``scripts/torch_bench_bvh.py`` at 1024, 2048 and 4096 objects (256^2 x
    1 spp x d2): dense and bvh in every row, mega at 1024 and 2048, and
    null at 4096, past the megakernel's shared memory."""
    from cpppathtracer_tpu_torch.bench import BENCH_GRAPHS, build_bench
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    repo = Path(__file__).resolve().parent
    rays = W * H * SPP * DEPTH
    torch.cuda.empty_cache()  # leave the card to the subprocesses
    for cmd in ([sys.executable, "-m", "cpppathtracer_tpu_torch", "bench"],
                [sys.executable, "bench_torch.py"]):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
        what = " ".join(cmd[1:])
        lines = proc.stdout.splitlines()
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"{what}: rc {proc.returncode}, {len(lines)} stdout lines:\n"
                                 f"{proc.stdout}\n{proc.stderr[-3000:]}")
        res = json.loads(lines[0])
        ms = float(re.search(r"([0-9.]+) ms/iter", proc.stderr).group(1))
        # the printed mean has 3 decimals: value lies within its half-unit
        lo, hi = rays / ((ms + 5e-4) / 1e3), rays / ((ms - 5e-4) / 1e3)
        for line in proc.stderr.splitlines():
            log(f"[bench] {what}: {line}")
        log(f"[bench] {what}: stdout {lines[0]} ({time.perf_counter() - t0:.1f} s)")
        if (sorted(res) != ["device", "metric", "unit", "value"] or res["unit"] != "rays/s"
                or res["metric"] != f"rays/s fwd+bwd {W}x{H}x{SPP}spp d{DEPTH} ({dev.type})"
                or res["device"] != card or not lo <= res["value"] <= hi):
            raise AssertionError(f"{what}: unexpected result {res} (card {card}, mean step "
                                 f"{ms} ms: value in [{lo}, {hi}])")

    step, b_scene, b_camera, b_sky = build_bench(W, H, SPP, DEPTH, dev)
    same_inputs = (same_fields(b_scene, scene) and same_fields(b_camera, camera)
                   and torch.equal(bits(b_sky), bits(sky)))
    first_ms, held = first_call_cost(step)  # the compiled step's warm-up, capture and replay
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    t0 = time.perf_counter()
    loss, grads = step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    BENCH_GRAPHS.clear()
    want = dict(mega_trace=2 * SPP, mega_trace_aux=0, stream_compact=SPP, stream_expand=SPP,
                mega_bwd=SPP, winner_index=0, bvh_winner_index=0, denoise=0)
    same_loss = torch.equal(bits(loss), bits(step_ref[0]))
    rel = {k: float((g - r).norm() / r.norm()) for (k, g), r in zip(grads.items(), step_ref[1:])}
    same_g = {k: torch.equal(bits(g), bits(r)) for (k, g), r in zip(grads.items(), step_ref[1:])}
    log(f"[bench] build_bench step {W}x{H} x {SPP} spp x d{DEPTH} on {card} (compiled, a "
        f"replay): {dt * 1e3:.1f} ms, {rays / dt / 1e6:.1f} Mrays/s fwd+bwd, peak {peak_gib:.2f} "
        f"GiB beside the graph's {held / 2**30:.2f} GiB held, first call {first_ms:.1f} ms, "
        f"launches {launches}")
    log(f"[check] build_bench against phase 5's loss_grads: scene, camera and sky bitwise "
        f"{same_inputs}; loss bitwise {same_loss}; gradients bitwise {same_g}, relative L2 {rel}")
    if launches != want:
        raise AssertionError(f"the bench step launched {launches}, expected {want}")
    if not (same_inputs and same_loss and max(rel.values()) <= 1e-4):
        raise AssertionError("build_bench's step differs from phase 5's loss_grads")
    del grads, step_ref

    with tempfile.TemporaryDirectory(prefix="poca_bvh_") as tmp:
        out = Path(tmp) / "crossover.json"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "scripts/torch_bench_bvh.py", "--sizes",
                               "1024,2048,4096", "--res", "256", "--spp", "1", "--depth", "2",
                               "--out", str(out)], cwd=repo, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"torch_bench_bvh.py: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        res = json.loads(out.read_text())
    for line in proc.stderr.splitlines() + proc.stdout.splitlines():
        log(f"[crossover] {line}")
    log(f"[crossover] {time.perf_counter() - t0:.1f} s; rows {json.dumps(res['rows'])}")
    for row in res["rows"]:
        has_mega = row["n_objects"] < 4096
        if not (row["dense_s"] and row["bvh_s"] and row["dense_busy_ms"] and row["bvh_busy_ms"]
                and bool(row["mega_s"]) == has_mega and bool(row["mega_busy_ms"]) == has_mega
                and ("mega_error" in row) != has_mega):
            raise AssertionError(f"crossover row for N = {row['n_objects']}: {row}")
    if res["backend"] != "cuda" or res["device"] != card:
        raise AssertionError(f"crossover ran on {res['backend']} / {res['device']}")


# a harness subprocess takes 14-36 s on the H100
HARNESS_TIMEOUT_S = 240


def run_harness(args):
    """A measurement harness under scripts/ in a subprocess on the card: rc
    0 and exactly one stdout line, its JSON; the stderr goes to the log.
    The harness runs in a session of its own, which is killed when it
    ends, so nothing it started outlives it; one that has not finished in
    HARNESS_TIMEOUT_S seconds is killed with every process it started (the
    scaling harness's ranks), and what it wrote to stderr is logged."""
    repo = Path(__file__).resolve().parent
    what = " ".join(args)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *args], cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=HARNESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        for line in err.splitlines():
            log(f"[harness] {line}")
        raise AssertionError(f"{what}: no result in {HARNESS_TIMEOUT_S} s; killed with its "
                             f"process group")
    with contextlib.suppress(ProcessLookupError):  # anything the harness left running
        os.killpg(proc.pid, signal.SIGKILL)
    for line in err.splitlines():
        log(f"[harness] {line}")
    lines = out.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"{what}: rc {proc.returncode}, {len(lines)} stdout lines:\n"
                             f"{out}\n{err[-3000:]}")
    log(f"[harness] {what}: {lines[0]} ({time.perf_counter() - t0:.1f} s)")
    return json.loads(lines[0])


def harness_phase(card, progressive_ms):
    """Phase 13: the card twins of the JAX package's video, scaling and
    progressive harnesses, each in a subprocess at a size cut to keep the
    script short.  (a) scripts/torch_bench_video.py, 4 frames of 256^2 x 2
    spp x d8: 4 checksums, the warm-up's frame 0 equal to the timed one,
    fps > 0, the render without the frame sink no slower than with it.
    (b) scripts/torch_bench_scaling.py at n = 1 (128^2 x 1 spp x d4), one
    process and a one-rank NCCL group: efficiency 1.0 in each mode, the
    in-harness check against the one-card step passed, the two modes'
    losses within rtol 1e-5.  (c) scripts/torch_perf_progressive.py, 8
    frames at 1280x720 x 1 spp x d8, denoiser on and off: the denoised
    ms a frame within a factor of 3 of phase 4's (`progressive_ms`),
    device busy time in both, and the JSON saying the loop ran compiled
    ("graphed": true)."""
    torch.cuda.empty_cache()  # leave the card to the subprocesses
    with tempfile.TemporaryDirectory(prefix="poca_harness_") as tmp:
        out = Path(tmp) / "video.json"
        summary = run_harness(["scripts/torch_bench_video.py", "--frames", "4", "--size", "256",
                               "--spp", "2", "--depth", "8", "--out", str(out)])
        video = json.loads(out.read_text())
        out = Path(tmp) / "scaling.json"
        run_harness(["scripts/torch_bench_scaling.py", "--counts", "1", "--tile", "128", "--spp",
                     "1", "--depth", "4", "--rank-timeout", "150", "--out", str(out)])
        scaling = json.loads(out.read_text())
    progressive = run_harness(["scripts/torch_perf_progressive.py", "--frames", "8"])

    sums = video["frame_sha256_16"]
    log(f"[harness] video: wall {video['wall_s']:.4f} s, render only "
        f"{video['render_only_wall_s']:.4f} s, one PNG {video['png_ms_per_frame']:.2f} ms, frame 0 "
        f"alone {video['first_frame_s']:.3f} s, "
        f"busy {video['busy_ms_per_frame']:.3f} ms a frame, checksums {sums}, warm-up's frame 0 "
        f"{video['warmup_frame0_sha256_16']}")
    if not (len(sums) == 4 and sums[0] == video["warmup_frame0_sha256_16"] and summary["fps"] > 0
            and video["device"] == summary["device"] == card):
        raise AssertionError(f"video harness: {summary}, {video}")
    if not video["render_only_wall_s"] <= video["wall_s"]:
        raise AssertionError(f"video harness: the render without the sink took "
                             f"{video['render_only_wall_s']} s, with it {video['wall_s']} s")

    rows = {r["mode"]: r for r in scaling["rows"]}
    for mode, r in rows.items():
        log(f"[harness] scaling {mode}: step {r['step_s'] * 1e3:.3f} ms, loss {r['loss']!r}, "
            f"comm {r['comm_step_s'] * 1e3:.4f} ms, dispatch {r['dispatch_s'] * 1e3:.4f} ms, "
            f"busy {r['busy_ms']:.3f} ms, check {r['check']}")
    loss1, loss2 = rows["process"]["loss"], rows["procs"]["loss"]
    if not (sorted(rows) == ["process", "procs"] and scaling["device"] == card
            and all(r["efficiency"] == 1.0 and r["check"]["ok"] and r["busy_ms"] > 0
                    for r in rows.values())
            and rows["procs"]["backend"] == "nccl" and abs(loss2 - loss1) <= 1e-5 * abs(loss1)):
        raise AssertionError(f"scaling harness: {scaling}")

    settings = {r["denoise"]: r for r in progressive["progressive"]}
    if sorted(settings) != [False, True]:
        raise AssertionError(f"progressive harness: {progressive}")
    ratio = settings[True]["ms_per_frame"] / progressive_ms
    log(f"[harness] progressive: {settings}; denoised {ratio:.3f}x phase 4's {progressive_ms:.3f} "
        f"ms/frame")
    if not (progressive["device"] == card and progressive["graphed"] and 1 / 3 <= ratio <= 3
            and all(r["busy_ms"] > 0 for r in settings.values())):
        raise AssertionError(f"progressive harness: {progressive} (phase 4: {progressive_ms} ms)")

# FP32 operations of the denoiser (csrc/denoise.cuh, counted as above): a weight factor
# (c_w * n_w) * p_w: the colour and normal distances 9 each (3 subtractions, 3 squares, 2
# adds, the 1/pi scale), the depth distance 3, 3 expf counted one each, 2 multiplies; a tap's
# sums: valid and k 2 multiplies, num and den 7; the 3 divisions of a pixel.  Bytes: 7
# floats read and 3 written a pixel.
OPS_DENOISE_FACTOR, OPS_DENOISE_TAP_SUM = 9 + 9 + 3 + 3 + 2, 2 + 7
OPS_DENOISE_PIXEL, BYTES_DENOISE_PIXEL = 3, 4 * (7 + 3)
# the instance stepwidth 1 launches: denoise_kernel<1, true>
DENOISE_STEP1 = "_Z14denoise_kernelILi1ELb1EEvPKfS1_S1_Pfiii"
# the SFU's rate for the ex2 of each expf: 16 a clock an SM
SFU_PER_S = 132 * 16 * 1.98e9
# the CUDA function that each launch counter of ops/cuda/build.py counts (one <<<>>> a call)
KERNEL_OF = dict(mega_trace="mega_trace_kernel", mega_trace_aux="mega_trace_kernel",
                 stream_compact="compact_kernel", stream_expand="expand_kernel",
                 winner_index="winner_index_kernel", bvh_winner_index="bvh_winner_kernel",
                 mega_bwd="mega_bwd_kernel", denoise="denoise_kernel")
# SASS opcodes that issue on the FP32 pipe
FP32_PIPE_OPS = ("FADD", "FMUL", "FFMA", "FMNMX")


def profiled_kernels(fn, need=()):
    """{CUDA function: (records, device ms)} of the port's kernels among the
    device records of fn() (device_records; a function of `need` missing
    takes the profile again)."""
    names = set(KERNEL_OF.values())
    out = {}
    for name, recs in device_records(fn, need=need)[0].items():
        f = function_of(name)
        if f in names:
            n, t = out.get(f, (0, 0.0))
            out[f] = (n + len(recs), t + sum(recs))
    return out


def seen_within(seen, counted):
    """Every kernel the wrappers counted has records, and no more records
    than launches; no other kernel of the port has any."""
    return set(seen) == set(counted) and all(0 < seen[k] <= counted[k] for k in counted)


def kernel_launches(launches):
    """The launches of each CUDA function that build.LAUNCHES counted."""
    out = {}
    for k, n in launches.items():
        if n:
            out[KERNEL_OF[k]] = out.get(KERNEL_OF[k], 0) + n
    return out


def graph_loop_ms(fn, n, replays=5):
    """Device ms a call of fn() from one CUDA graph of n calls, timed by
    CUDA events over `replays` replays: no host time between launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * n)
    graph.reset()
    return ms


def sass_opcodes(lib_path, mangled):
    """Opcode counts of one function's SASS in the kernel library, from
    cuobjdump beside nvcc (a static count: each instruction once), or None
    without the tool; opcodes without their modifiers, and LDS.128 apart."""
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    tool = Path(kb._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip() == mangled
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)", line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
            if m.group(1) == "LDS" and ".128" in m.group(2):
                counts["LDS.128"] = counts.get("LDS.128", 0) + 1
    return counts or None


def first_call_cost(fn):
    """Wall ms of fn()'s first call (on a graphed call: the warm-up, the
    capture and the first replays) and the device memory it left held
    once the allocator's free cache is released (the graphs' pools and
    static buffers; fn's result is dropped first)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    return ms, torch.cuda.memory_reserved() - mem0


def compiled_phase(dev, card, scene, camera, sky, progressive_ms, lib_path):
    """Phase 14: the compiled serving calls and the denoise kernel.
    (a) csrc/denoise.cu against its plain version: on the progressive
    frame's own buffers at 1280x720, on seeded random inputs at odd sizes
    (H or W under 5 among them, the 32 x 16 tile exactly, one pixel under
    and over a multiple of it in each direction) and on the frame with
    inf and NaN radiance, stepwidths 0-3 and 17 (the tiled kernel of
    stepwidth 1 and the untiled one of the others), bitwise, NaN where the plain version is NaN; its time
    beside its bound (each pair's weight factor counted once; also with 25
    factors a pixel, every pixel's own) and the plain version's: by CUDA
    events around the wrapper, the mean device time of the kernel records
    of 200 launches, and a CUDA graph of 100 launches timed by events; the
    SASS opcode counts of its stepwidth-1 instance.  (b)
    render_radiance_jit against render_radiance bitwise on demo_scene(0)
    at 1024^2 x 64 spp x d8, the textured demo at 1024^2 x 4 spp,
    big_scene(16384) at 1024^2 x 4 spp x d8 and route A at 512^2 x 2 spp x
    d8 (cut: route A is JAX's dense fallback), each with wall ms a sample
    of both, device busy ms, the first call's ms and the memory it left
    held, and the launches of a replayed call, both as the wrappers
    counted them and as torch.profiler saw them under replay.  (c)
    Replays after an in-place kd edit, a moved camera and a new sky:
    bitwise with eager, no new capture.  (d) 16 compiled progressive
    1280x720 frames against frame_step, denoiser on and off, every frame's
    mix bitwise; ms a frame, busy ms and share of both; the launches of 16
    compiled frames as counted, each kernel among torch.profiler's records
    (which lose some launches, so at most as many).  Returns the
    denoise kernel's row."""
    from cpppathtracer_tpu_torch.bench import busy_ms
    from cpppathtracer_tpu_torch.integrator import (
        RENDER_GRAPHS, render_radiance, render_radiance_jit,
    )
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise, denoise_plain
    from cpppathtracer_tpu_torch.renderer import (
        AccumulatorState, ProgressiveRenderer, RenderConfig, frame_step,
    )

    # (a) the denoise kernel on the progressive frame's buffers and on random inputs
    pcam = Camera.make(PROG_W, PROG_H, device=dev, **CAMERA)
    with torch.no_grad():
        rad, n0, t0 = render_radiance(scene, pcam, sky, spp=1, max_depth=DEPTH, seed=0)
    frame_in = (rad.reshape(PROG_H, PROG_W, 3), n0.reshape(PROG_H, PROG_W, 3),
                t0.reshape(PROG_H, PROG_W))
    g = torch.Generator(device=dev).manual_seed(13)
    cases = [("frame 1280x720", frame_in)]
    # odd sizes, H or W under 5, the 32 x 16 tile exactly, one pixel under and over a multiple
    # of it in each direction
    for h, w in ((721, 1281), (29, 37), (3, 17), (4, 2), (1, 1), (16, 32), (15, 31), (17, 33),
                 (31, 65), (33, 63)):
        cases.append((f"random {w}x{h}", (2 * torch.rand((h, w, 3), device=dev, generator=g),
                                          torch.randn((h, w, 3), device=dev, generator=g),
                                          50 * torch.rand((h, w), device=dev, generator=g))))
    bad = frame_in[0].clone()  # the frame with inf and NaN radiance, edges and inside
    for y, x, c, v in ((PROG_H // 2, PROG_W // 3, 0, float("inf")), (0, PROG_W - 1, 1, float("nan")),
                       (PROG_H - 1, 0, 2, -float("inf")), (PROG_H // 3, PROG_W // 2, 1, float("nan"))):
        bad[y, x, c] = v
    cases.append(("frame 1280x720 with inf and NaN", (bad, *frame_in[1:])))
    max_err, failed, n_checked, n_nan = 0.0, [], 0, 0
    for what, args in cases:
        for step in (0, 1, 2, 3, 17):  # 1: the tiled kernel; the others the untiled one
            got, ref = denoise(*args, step), denoise_plain(*args, step)
            n_checked += 1
            nan = torch.isnan(ref)
            n_nan += int(nan.sum())
            if not (torch.equal(torch.isnan(got), nan)
                    and torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32))):
                fin = torch.isfinite(got) & torch.isfinite(ref)
                err = float((got[fin] - ref[fin]).abs().max()) if fin.any() else float("nan")
                max_err = max(max_err, err)
                failed.append((what, step))
                log(f"[denoise] {what} stepwidth {step}: not bitwise (NaN masks equal "
                    f"{torch.equal(torch.isnan(got), nan)}), max |d| {err:.3e}")
    log(f"[check] denoise kernel vs plain version on {n_checked} cases (the 1280x720 frame's "
        f"buffers, random inputs at 1281x721, 37x29, 17x3, 2x4, 1x1, 32x16, 31x15, 33x17, 65x31, "
        f"63x33, the frame with inf and NaN radiance ({n_nan} NaN outputs in all); stepwidths 0-3 and 17): "
        f"{'bitwise equal, NaN where the plain version is' if not failed else f'{len(failed)} differ'}")
    if failed:
        raise AssertionError(f"the denoise kernel differs from its plain version on {failed}")
    dn = lambda: denoise(*frame_in)
    ms_dn = time_ms(dn, iters=50)
    def launches_200():
        for _ in range(200):
            dn()

    recs, host = device_records(launches_200, need=("denoise_kernel",))
    rec_dn = [t for k, ts in recs.items() if function_of(k) == "denoise_kernel" for t in ts]
    n_rec, dev_dn = len(rec_dn), sum(rec_dn) / len(rec_dn)  # the mean of the records
    lost = [i for i, c in enumerate(host) if c is None]
    graph_dn = graph_loop_ms(dn, 100)
    plain_dn = time_ms(lambda: denoise_plain(*frame_in), iters=5)
    px = PROG_W * PROG_H
    # the function's operations: each pair's weight factor once (12 and the centre's a pixel,
    # csrc/denoise.cuh's pairs), beside the count of 25 factors a pixel, every pixel's own
    ops_dn = px * (13 * OPS_DENOISE_FACTOR + 25 * OPS_DENOISE_TAP_SUM + OPS_DENOISE_PIXEL)
    ops_25 = px * (25 * (OPS_DENOISE_FACTOR + OPS_DENOISE_TAP_SUM) + OPS_DENOISE_PIXEL)
    bytes_dn = px * BYTES_DENOISE_PIXEL
    by_dn = "operations" if ops_dn / FP32_OPS_PER_S > bytes_dn / HBM_BYTES_PER_S else "bytes"
    bound_dn = max(ops_dn / FP32_OPS_PER_S, bytes_dn / HBM_BYTES_PER_S) * 1e3
    bound_25 = max(ops_25 / FP32_OPS_PER_S, bytes_dn / HBM_BYTES_PER_S) * 1e3
    log(f"[kernels] denoise {PROG_W}x{PROG_H}, stepwidth 1: {ms_dn:.5f} ms by events around the "
        f"wrapper; device {dev_dn:.5f} ms (the mean of the {n_rec} kernel records torch.profiler "
        f"kept of 200 launches; launches without a record, in order: {lost}), {graph_dn:.5f} ms (a CUDA graph of 100 launches, by events); bound "
        f"{bound_dn:.5f} ms ({by_dn}: {ops_dn:.4g} FP32 operations with each pair's factor once, "
        f"{ops_dn / FP32_OPS_PER_S * 1e3:.5f} ms; {bytes_dn / 1e6:.2f} MB, "
        f"{bytes_dn / HBM_BYTES_PER_S * 1e3:.5f} ms), {graph_dn and bound_dn / graph_dn:.3f} of it; "
        f"with 25 factors a pixel {bound_25:.5f} ms ({ops_25:.4g} operations), "
        f"{graph_dn and bound_25 / graph_dn:.3f} of it; --fmad=false floor of the counted "
        f"operations {ops_dn / FP32_INSTR_PER_S * 1e3:.5f} ms (25 factors "
        f"{ops_25 / FP32_INSTR_PER_S * 1e3:.5f}); the expf's ex2 on the SFU "
        f"{39 * px / SFU_PER_S * 1e3:.5f} ms (25 factors {75 * px / SFU_PER_S * 1e3:.5f}); plain "
        f"{plain_dn:.4f} ms; {card}")
    sass = sass_opcodes(lib_path, DENOISE_STEP1)
    if sass is None:
        log("[sass] denoise_kernel: cuobjdump not found beside nvcc; not counted")
    else:
        fp32 = sum(sass.get(op, 0) for op in FP32_PIPE_OPS)
        top = dict(sorted(sass.items(), key=lambda kv: -kv[1])[:16])
        n_sass = sum(n for op, n in sass.items() if "." not in op)
        log(f"[sass] {DENOISE_STEP1} (denoise_kernel<1, true>, static: each instruction once, the "
            f"loops' bodies and both the interior and the edge taps): {n_sass} instructions, "
            f"{fp32} on the FP32 pipe ({', '.join(f'{op} {sass.get(op, 0)}' for op in FP32_PIPE_OPS)}), "
            f"MUFU {sass.get('MUFU', 0)}, LDS {sass.get('LDS', 0)} (LDS.128 "
            f"{sass.get('LDS.128', 0)}); opcodes {top}")

    # (b) render_radiance_jit against render_radiance on each route
    tex_scene, tex = textured_scene(scene, dev)
    cfgs = [
        ("demo", scene, camera, dict(spp=SPP), {}, "mega_trace_kernel"),
        ("textured demo", tex_scene, camera, dict(spp=TEX_SPP, tex_stack=tex), {},
         "mega_trace_kernel"),
        (f"big_scene({BVH_N})", big_scene(BVH_N, device=dev), big_camera(BVH_N, W, H, device=dev),
         dict(spp=WF_SPP), {}, "bvh_winner_kernel"),
        ("route A", scene, camera.resize(W // 2, H // 2), dict(spp=2),
         dict(POCA_MEGA="0", POCA_PLANAR="0"), "winner_index_kernel"),
    ]
    for what, sc, cam, kw, switches, kernel in cfgs:
        kw = dict(kw, max_depth=DEPTH, seed=0)
        spp = kw["spp"]
        with torch.no_grad(), env(**switches):
            RENDER_GRAPHS.clear()
            jit = lambda: render_radiance_jit(sc, cam, sky, **kw)
            eager = lambda: render_radiance(sc, cam, sky, **kw)
            eager()  # warm
            first_ms, held = first_call_cost(jit)  # the warm-up, the capture, the replays
            captures = RENDER_GRAPHS.captures
            walls = {}
            for name, fn in (("jit", jit), ("eager", eager), ("eager", eager), ("jit", jit)):
                torch.cuda.synchronize()
                kb.reset_launches()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.setdefault(name, []).append((time.perf_counter() - t0) * 1e3 / spp)
                if name == "jit":
                    got, launches = out, dict(kb.LAUNCHES)
                else:
                    ref, eager_launches = out, dict(kb.LAUNCHES)
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, ref))
            del got, ref, out
            busy_jit, busy_eager = busy_ms(jit, dev), busy_ms(eager, dev)
            kb.reset_launches()
            seen = {k: n for k, (n, _) in profiled_kernels(jit, need=(kernel,)).items()}
            counted = kernel_launches(kb.LAUNCHES)
        capture_ms = first_ms - spp * min(walls["jit"])
        log(f"[compiled] {what} {cam.width}x{cam.height} x {spp} spp x d{DEPTH}: ms a sample "
            f"jit {walls['jit']} eager {walls['eager']}; device busy per call jit "
            f"{busy_jit:.3f} ms, eager {busy_eager:.3f} ms; first call {first_ms:.1f} ms (warm-up "
            f"and capture {capture_ms:.1f} ms beside a replayed call), {held / 2**20:.1f} MiB "
            f"held after it; launches of a replayed call {launches} (eager {eager_launches}); "
            f"bitwise equal {same}; kernels of a replayed call, counted {counted}, records "
            f"torch.profiler kept {seen}; {card}")
        if not (same and launches == eager_launches and RENDER_GRAPHS.captures == captures
                and seen_within(seen, counted)):
            raise AssertionError(f"render_radiance_jit on {what}: bitwise {same}, launches "
                                 f"{launches} vs {eager_launches}, profiler saw {seen} "
                                 f"against {counted}")
        RENDER_GRAPHS.clear()

    # (c) replays after in-place and value changes: no recapture
    kw = dict(spp=4, max_depth=DEPTH, seed=0)
    sc = demo_scene(0).build(device=dev)
    cam, sky2 = camera, sky.flip(0).contiguous()
    with torch.no_grad():
        render_radiance_jit(sc, cam, sky, **kw)
        captures = RENDER_GRAPHS.captures
        checks = []
        for change in ("kd edited in place", "camera moved", "new sky"):
            if change.startswith("kd"):
                sc.kd.mul_(0.75)
            elif change.startswith("camera"):
                cam = cam.move_forward(3.0).rotate_left(0.05)
            else:
                sky = sky2
            got = render_radiance_jit(sc, cam, sky, **kw)
            ref = render_radiance(sc, cam, sky, **kw)
            checks.append(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                              for a, b in zip(got, ref)))
    log(f"[compiled] replays after {['kd edited in place', 'camera moved', 'new sky']}: bitwise "
        f"{checks}, captures {RENDER_GRAPHS.captures - captures} new")
    if not all(checks) or RENDER_GRAPHS.captures != captures:
        raise AssertionError("a replay after an input change differs from eager or recaptured")
    RENDER_GRAPHS.clear()

    # (d) the compiled progressive loop against frame_step
    denoise_launches = None
    for use_dn in (True, False):
        cfg = RenderConfig(width=PROG_W, height=PROG_H, max_depth=DEPTH, denoise=use_dn)
        r = ProgressiveRenderer(scene, pcam, sky, cfg)
        state = AccumulatorState.create(PROG_H, PROG_W, dev)
        first_ms, held = first_call_cost(r.step)
        state, ref = frame_step(scene, pcam, sky, state, 0, DEPTH, use_dn)
        bits_ok = bits(r.state.mix).equal(bits(ref))  # the first frame's image
        for _ in range(16):
            img = r.step()
            state, ref = frame_step(scene, pcam, sky, state, 0, DEPTH, use_dn)
            bits_ok = bits_ok and bits(img).equal(bits(ref))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            r.step()
        torch.cuda.synchronize()
        ms_graph = (time.perf_counter() - t0) * 1e3 / 16
        kb.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            state, _ = frame_step(scene, pcam, sky, state, 0, DEPTH, use_dn)
        torch.cuda.synchronize()
        ms_eager = (time.perf_counter() - t0) * 1e3 / 16
        eager_launches = dict(kb.LAUNCHES)
        # the launches of 16 compiled frames: as the replays counted them, and as the
        # device's kernel records show them
        kb.reset_launches()
        def frames_16():
            for _ in range(16):
                r.step()

        need = ("mega_trace_kernel", "denoise_kernel") if use_dn else ("mega_trace_kernel",)
        seen = {k: n for k, (n, _) in profiled_kernels(frames_16, need=need).items()}
        graph_launches = dict(kb.LAUNCHES)
        counted = kernel_launches(graph_launches)
        busy_graph = busy_ms(r.step, dev)
        busy_eager = busy_ms(lambda: frame_step(scene, pcam, sky, state, 0, DEPTH, use_dn), dev)
        log(f"[compiled] progressive {PROG_W}x{PROG_H} x1 spp x d{DEPTH} denoise={use_dn}: 17 frames "
            f"bitwise equal to frame_step {bits_ok}; ms a frame compiled {ms_graph:.3f}, eager "
            f"{ms_eager:.3f} (phase 4 {progressive_ms:.3f}); busy compiled {busy_graph:.3f} ms "
            f"({busy_graph / ms_graph:.3f}), eager {busy_eager:.3f} ms "
            f"({busy_eager / ms_eager:.3f}); capture and first frame {first_ms:.1f} ms, "
            f"{held / 2**20:.1f} MiB held after it; launches of 16 compiled frames {graph_launches}, "
            f"records torch.profiler kept {seen}; {card}")
        if not bits_ok or r.graphs.captures != 1:
            raise AssertionError(f"compiled progressive frames (denoise={use_dn}) differ from "
                                 f"frame_step, or recaptured")
        if not (graph_launches == eager_launches and seen_within(seen, counted)
                and graph_launches["denoise"] == 16 * use_dn and graph_launches["mega_trace"] == 32):
            raise AssertionError(f"16 compiled frames launched {graph_launches} (profiler: {seen}), "
                                 f"16 eager frames {eager_launches}")
        if use_dn:
            denoise_launches = graph_launches["denoise"]
    return dict(name="denoise", route="cuda", source="cpppathtracer_tpu_torch/csrc/denoise.cu",
                replaces="cpppathtracer_tpu/ops/denoise.py:39 (XLA's fused pass; no pallas_call)",
                launches=denoise_launches, max_abs_err=max_err, ms=ms_dn, plain_ms=plain_dn,
                bound_ms=bound_dn, bound_by=by_dn, library_ms=None, device_ms=dev_dn,
                graph_ms=graph_dn)


def rel_l2(a, b):
    """Relative L2 difference of a from b, in float64."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm()) if b.norm() > 0 else float((a - b).norm())


def worst_rel(x, y):
    """The largest relative L2 difference, tensor by tensor, between two
    runs (dicts of tensors)."""
    return max(rel_l2(x[k], y[k]) for k in x)


def held_to_eager(got, runs):
    """(d, bar, ok) for a compiled run `got` against repeated runs of the
    same eager work (dicts of tensors): d, worst_rel from `got` to the
    nearest eager run; bar, the eager runs' own run-to-run difference (the
    largest worst_rel between two of them: mega_bwd's float atomics and
    index_add_ sum in another order on every run); ok, d within twice
    bar, or bitwise where the eager runs repeat bitwise.  Twice: the
    compiled run is one more draw of the same summation orders, and the
    spread of three draws does not always cover a fourth."""
    d = min(worst_rel(got, r) for r in runs)
    bar = max(worst_rel(x, y) for i, x in enumerate(runs) for y in runs[i + 1:])
    if bar == 0.0:
        return d, bar, all(torch.equal(bits(got[k]), bits(runs[0][k])) for k in got)
    return d, bar, d <= 2 * bar


def train_compiled_phase(dev, card, scene, camera, sky, step_want):
    """Phase 15: the compiled training steps (CUDA graphs of the whole
    forward, backward and, for inverse, Adam update).  For each training
    route, bench.train_step_jit against the eager bench.train_step: the
    demo step at 1024^2 x 64 spp x d8 (the bench size), the textured demo
    at 1024^2 x 2 spp x d8, big_scene(16384) at 1024^2 x 4 spp x d8 (the
    wavefront path and the BVH walk) and route A at 256^2 x 1 spp x d4
    (POCA_MEGA=0 POCA_PLANAR=0).  Each: the first call's ms (warm-up,
    capture and one replay) and the memory it left held; compiled and eager
    steps in turns (compiled, eager, eager, compiled, eager), wall ms and
    rays/s fwd+bwd; the loss of every run bitwise the first eager run's;
    the gradients of both compiled runs within held_to_eager's bar of the
    three eager runs; a replay's launches those of an eager step (on the
    demo also `step_want`, phase 5's); device busy ms and share of both;
    each kernel a replay counted among torch.profiler's records of a
    replay.  Then inverse.make_train_step's compiled step (demo, 1024^2 x
    4 spp x d4, kd and emission, fixed samples) for three steps against
    three eager runs of three steps: the first loss bitwise, the
    parameters and last loss after three steps within the bar, one
    capture, a replay's launches those of an eager step, and
    train_step.graphs.clear() giving back the memory its capture held.
    Any failure raises."""
    from cpppathtracer_tpu_torch import bench
    from cpppathtracer_tpu_torch.bench import busy_ms
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.inverse import InverseConfig, make_train_step
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.ops.cuda import build as kb

    tex_scene, tex = textured_scene(scene, dev)
    routes = [
        ("demo", scene, camera, SPP, DEPTH, None, {}, "mega_bwd_kernel"),
        ("textured demo", tex_scene, camera, 2, DEPTH, tex, {}, "mega_bwd_kernel"),
        (f"big_scene({BVH_N})", big_scene(BVH_N, device=dev), big_camera(BVH_N, W, H, device=dev),
         WF_SPP, DEPTH, None, {}, "bvh_winner_kernel"),
        ("route A", scene, Camera.make(256, 256, device=dev, **CAMERA), 1, 4, None,
         dict(POCA_MEGA="0", POCA_PLANAR="0"), "winner_index_kernel"),
    ]
    for what, sc, cam, spp, depth, tx, switches, kernel in routes:
        rays = cam.width * cam.height * spp * depth
        with env(**switches):
            bench.BENCH_GRAPHS.clear()
            jit = lambda: bench.train_step_jit(sc, cam, sky, spp, depth, tx)
            eager = lambda: bench.train_step(sc, cam, sky, spp, depth, tex_stack=tx)
            eager()  # warm
            captures = bench.BENCH_GRAPHS.captures
            first_ms, held = first_call_cost(jit)
            walls, outs, launches = {}, {}, {}
            for name, fn in (("jit", jit), ("eager", eager), ("eager", eager), ("jit", jit),
                             ("eager", eager)):
                torch.cuda.synchronize()
                kb.reset_launches()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
                outs.setdefault(name, []).append(out)
                launches.setdefault(name, []).append(dict(kb.LAUNCHES))
            del out
            loss0 = outs["eager"][0][0]
            same_loss = all(torch.equal(bits(l), bits(loss0))
                            for l, _ in outs["jit"] + outs["eager"])
            eager_g = [g for _, g in outs["eager"]]
            held_g = [held_to_eager(g, eager_g) for _, g in outs["jit"]]
            same_launches = all(x == launches["eager"][0]
                                for x in launches["jit"] + launches["eager"])
            if what == "demo":
                same_launches = same_launches and launches["jit"][0] == step_want
            busy_jit, busy_eager = busy_ms(jit, dev), busy_ms(eager, dev)
            kb.reset_launches()
            seen = {k: n for k, (n, _) in profiled_kernels(jit, need=(kernel,)).items()}
            counted = kernel_launches(kb.LAUNCHES)
            new_captures = bench.BENCH_GRAPHS.captures - captures
            bench.BENCH_GRAPHS.clear()
        ms_jit, ms_eager = (sum(walls[k]) / len(walls[k]) for k in ("jit", "eager"))
        log(f"[train-compiled] {what} {cam.width}x{cam.height} x {spp} spp x d{depth}: ms a step "
            f"compiled {walls['jit']} eager {walls['eager']}; rays/s fwd+bwd compiled "
            f"{rays / ms_jit * 1e3:.4g}, eager {rays / ms_eager * 1e3:.4g}; device busy compiled "
            f"{busy_jit:.3f} ms ({busy_jit / ms_jit:.3f} of the mean step), eager "
            f"{busy_eager:.3f} ms ({busy_eager / ms_eager:.3f}); first call {first_ms:.1f} ms, "
            f"{held / 2**30:.3f} GiB held after it; {card}")
        log(f"[train-compiled] {what}: losses bitwise {same_loss} ({float(loss0):.8g}); gradients "
            f"of the two compiled runs, relative L2 from the nearest of three eager runs "
            f"{[d for d, _, _ in held_g]}, the eager runs' own spread {held_g[0][1]:.3e}: within "
            f"twice it {[ok for _, _, ok in held_g]}; launches of a replay {launches['jit'][0]}, "
            f"of an eager step {launches['eager'][0]}: equal {same_launches}; kernels of a replay, "
            f"counted {counted}, records torch.profiler kept {seen}; captures {new_captures}")
        if not (same_loss and all(ok for _, _, ok in held_g) and same_launches and new_captures == 1
                and seen_within(seen, counted)):
            raise AssertionError(f"the compiled training step on {what} differs from the eager one")
        del outs

    # inverse.make_train_step: three compiled steps against three eager runs of three steps
    cfg = InverseConfig(fields=("kd", "emission"), fixed_samples=True)
    gen_kd = torch.Generator(device=dev).manual_seed(1)
    kd_true = (scene.kd + 0.2 * torch.rand(scene.kd.shape, device=dev, generator=gen_kd)
               - 0.1).clamp(0, 1)
    with torch.no_grad():
        target, _, _ = render_radiance(scene.with_material_params({"kd": kd_true}), camera, sky,
                                       spp=cfg.spp, max_depth=cfg.max_depth, seed=cfg.seed)
    finals, firsts, step_ms, step_launches = [], [], {}, {}
    for eager_form in (False, True, True, True):
        init, train_step = make_train_step(camera, cfg, eager=eager_form)
        params, opt = init(scene, sky)
        name = "eager" if eager_form else "compiled"
        losses = []
        for k in range(3):
            run = lambda: losses.append(train_step(params, opt, scene, sky, target, k)[2])
            if k == 0 and not eager_form:
                first_ms, held = first_call_cost(run)  # warm-up, capture, the first replay
                continue
            torch.cuda.synchronize()
            kb.reset_launches()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            step_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            step_launches.setdefault(name, []).append(dict(kb.LAUNCHES))
        firsts.append(losses[0])
        finals.append(dict(params["mat"], loss=losses[2]))
        if not eager_form:
            inv_captures = train_step.graphs.captures
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_reserved()
            train_step.graphs.clear()
            torch.cuda.empty_cache()
            freed = mem0 - torch.cuda.memory_reserved()
    same_first = all(torch.equal(bits(f), bits(firsts[0])) for f in firsts)
    d, bar, ok = held_to_eager(finals[0], finals[1:])
    same_launches = all(x == step_launches["eager"][0]
                        for x in step_launches["compiled"] + step_launches["eager"])
    log(f"[train-compiled] inverse.make_train_step demo {W}x{H} x {cfg.spp} spp x "
        f"d{cfg.max_depth} (kd, emission; fixed samples): first loss bitwise {same_first} "
        f"({float(firsts[0]):.8g}); after 3 steps parameters and loss relative L2 from the nearest "
        f"of three eager runs {d:.3e}, the eager runs' own spread {bar:.3e}, within twice it "
        f"{ok} (losses compiled {float(finals[0]['loss']):.8g}, eager "
        f"{[float(f['loss']) for f in finals[1:]]}); "
        f"ms a step compiled {step_ms['compiled']} eager {step_ms['eager']}; first call "
        f"{first_ms:.1f} ms, {held / 2**30:.3f} GiB held, {freed / 2**30:.3f} GiB given back by "
        f"graphs.clear(); captures {inv_captures}; launches equal {same_launches} "
        f"({step_launches['compiled'][0]}); {card}")
    if not (same_first and ok and same_launches and inv_captures == 1 and freed >= held):
        raise AssertionError("inverse.make_train_step's compiled step differs from the eager one, "
                             "recaptured, or kept its memory after graphs.clear()")


# Phase 6's times of #1 (a sample's phase A + B) and #8 (a sample) in PR 15's runs of this
# script, calls (c) and (f) (PERF.md), for phase 16 (a) to print beside this run's
PR15_MEGA_MS, PR15_BWD_MS = (0.915, 0.900), (1.729, 1.749)
SEED_WORDS = (0, 1, 2**31 + 5, -3)  # the seeds of phase 16 (a)
VIDEO_FRAMES, VIDEO_SPP = 24, 16  # scripts/torch_bench_video.py's defaults (phase 16 (c))
MESH_FRAMES = 4  # the frames of phase 16 (c)'s 2x2 mesh video


def flat_outputs(out):
    """The tensors of a kernel's nested outputs, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out if x is not None for t in flat_outputs(x)]


def all_bits_equal(a, b):
    """Nested outputs of 32-bit tensors bitwise equal."""
    return same_bits(flat_outputs(a), flat_outputs(b))


def seed_graphs_phase(dev, card, scene, camera, sky, trace_args, gs, bwd_args, phase6_ms):
    """Phase 16: the seed as a device word, and the graphs it lets one
    capture serve.  (a) mega_trace (both forms) and mega_bwd (both
    instances) on the main path's shapes (1024^2 primaries, depth 8) at
    seeds 0, 1, 2^31 + 5 and -3, with the seed as an int and as a device
    word: the trace bitwise its plain version and the kernel given the int;
    the backward's per-ray cotangents and carry bitwise the kernel given
    the int, the table cotangents within compare_bwd's bounds (its float
    atomics add in another order each run), against its plain version
    under compare_bwd's bounds; phase 6's times beside PR 15's.  (b)
    render_radiance_jit at 1024^2 x 4 spp x d8 over seeds 0, 1, 2: one
    capture, each bitwise the eager render; ProgressiveRenderer.step over
    two configs that differ only in seed: one frame graph, bitwise
    frame_step.  (c) the video: the demo orbit, 24 frames of 1024^2 x 16
    spp x d8, compiled (video.render_video) and eager (write_frames with no
    runner), every PNG byte-equal, one capture; frames/s with and without
    the sink, ms a frame, busy share, the first call and the graph's
    memory; then 4 frames over a virtual 2x2 mesh, byte-equal to the eager
    mesh video.  (d) render_image_sharded at 1024^2 x 4 spp x d8 tiled 1x1
    and 2x2: bitwise the eager tiles, one capture per (device, tile
    shape), none for a second frame at another seed and camera; ms a frame
    both ways.  (e) inverse.fit with optimizer=sgd and a callback that
    reads params["mat"]["kd"], against make_train_step(eager=True): the
    first loss bitwise, the later ones held to three eager runs as phase
    15 holds them.  Every check raises."""
    from cpppathtracer_tpu_torch import inverse, video
    from cpppathtracer_tpu_torch.bench import busy_ms
    from cpppathtracer_tpu_torch.integrator import (
        RENDER_GRAPHS, render_radiance, render_radiance_jit,
    )
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd, mega_bwd_plain
    from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import mega_trace, mega_trace_plain
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.parallel.render import (
        render_image_sharded, render_tiles, tile_graphs,
    )
    from cpppathtracer_tpu_torch.renderer import (
        AccumulatorState, ProgressiveRenderer, RenderConfig, frame_step,
    )
    from cpppathtracer_tpu_torch.utils.graphs import GraphedCall
    from cpppathtracer_tpu_torch.utils.rng import seed_word

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    # (a) the seed word in #1 and #8
    o, d, pix, samp, _, ts, trt, _, cts = bwd_args
    r = pix.shape[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    noise = torch.randn((4 * DEPTH, r), device=dev, generator=gen)
    for seed in SEED_WORDS:
        word = seed_word(seed, dev)
        at = lambda s: (trace_args[:4] + (s,) + trace_args[5:])
        for aux in (False, True):
            kw = dict(counts=gs.counts, depth=DEPTH, with_aux=aux)
            by_int = mega_trace(*at(seed), **kw)
            by_word = mega_trace(*at(word), **kw)
            plain = mega_trace_plain(*at(word), **kw)
            same_int, same_plain = all_bits_equal(by_int, by_word), all_bits_equal(by_word, plain)
            log(f"[seed] mega_trace{'(with_aux)' if aux else ''} seed {seed} (word "
                f"{int(word[0])}), {W}x{H} primaries x d{DEPTH}: the device word bitwise the int "
                f"{same_int}, bitwise the plain version {same_plain}")
            if not (same_int and same_plain):
                raise AssertionError(f"mega_trace with the seed word {seed} differs")
            if not aux:
                hits = torch.stack(by_word[6]).contiguous()
        ct_aux = torch.where(hits.repeat_interleave(4, 0) >= 0, noise, 0.0)
        for aux in (None, ct_aux):
            args = (o, d, pix, samp)
            by_int = mega_bwd(*args, seed, ts, trt, hits, cts, ct_aux=aux, with_carry=True)
            by_word = mega_bwd(*args, word, ts, trt, hits, cts, ct_aux=aux, with_carry=True)
            rays = lambda g: [*g[2], *g[3], *flat_outputs(g[4])]
            same_rays = all_bits_equal(rays(by_int), rays(by_word))
            what = f"mega_bwd{'(ct_aux)' if aux is not None else ''} seed {seed}"
            compare_bwd(by_word, by_int, f"{what}, the device word against the int")
            compare_bwd(by_word, mega_bwd_plain(*args, word, ts, trt, hits, cts, ct_aux=aux),
                        f"{what}, the device word against the plain version")
            log(f"[seed] {what}: ct_o, ct_d and the rebuilt carry bitwise the int's {same_rays}")
            if not same_rays:
                raise AssertionError(f"{what}: the per-ray outputs differ with the seed word")
    n_rep, n_pad = trace_args[5].shape[0], ts.shape[1]
    regs = [kernel_info(kb.library().poca_mega_info, a, r, n_rep, n_pad, n=4)[:2] for a in (0, 1)]
    regs_b = [kernel_info(kb.library().poca_mega_bwd_info, n_pad, 1, a, n=3)[:2] for a in (0, 1)]
    log(f"[seed] phase 6 with the seed word: mega_trace {phase6_ms[0]:.3f} ms a sample (PR 15 "
        f"(c), (f): {PR15_MEGA_MS[0]}, {PR15_MEGA_MS[1]}), mega_bwd {phase6_ms[1]:.3f} ms a sample "
        f"(PR 15: {PR15_BWD_MS[0]}, {PR15_BWD_MS[1]}); registers and local bytes a thread: "
        f"mega_trace_kernel<false> {regs[0]}, <true> {regs[1]}, mega_bwd_kernel<true, false> "
        f"{regs_b[0]}, <true, true> {regs_b[1]}; {card}")

    # (b) one captured render over seeds, and the progressive frame over configs
    RENDER_GRAPHS.clear()
    c0 = RENDER_GRAPHS.captures
    kw = dict(spp=4, max_depth=DEPTH)
    with torch.no_grad():
        for seed in (0, 1, 2):
            got, ms_jit = timed(lambda: render_radiance_jit(scene, camera, sky, seed=seed, **kw))
            ref, ms_eager = timed(lambda: render_radiance(scene, camera, sky, seed=seed, **kw))
            same = all_bits_equal(got, ref)
            captures = RENDER_GRAPHS.captures - c0
            log(f"[seed] render_radiance_jit {W}x{H} x 4 spp x d{DEPTH}, seed {seed}: bitwise the "
                f"eager render {same}, captures {captures} ({ms_jit:.1f} ms, eager "
                f"{ms_eager:.1f} ms); {card}")
            if not (same and captures == 2 and len(RENDER_GRAPHS.keys()) == 1):
                raise AssertionError(f"render_radiance_jit at seed {seed} differs or recaptured")
    RENDER_GRAPHS.clear()
    pcam = Camera.make(PROG_W, PROG_H, device=dev, **CAMERA)
    graphs = GraphedCall(max_entries=2)
    for seed in (0, 7):
        cfg = RenderConfig(width=PROG_W, height=PROG_H, max_depth=DEPTH, seed=seed)
        prog = ProgressiveRenderer(scene, pcam, sky, cfg)
        prog.graphs = graphs
        state = AccumulatorState.create(PROG_H, PROG_W, dev)
        same = True
        for _ in range(3):
            img = prog.step()
            state, ref = frame_step(scene, pcam, prog.sky_tex, state, seed, DEPTH, cfg.denoise)
            same &= torch.equal(bits(img), bits(ref))
        log(f"[seed] ProgressiveRenderer.step {PROG_W}x{PROG_H}, config seed {seed}: 3 frames "
            f"bitwise frame_step {same}, frame graphs captured {graphs.captures}")
        if not (same and graphs.captures == 1):
            raise AssertionError(f"the progressive frame at seed {seed} differs or recaptured")
    graphs.clear()

    # (c) the video: the demo orbit at scripts/torch_bench_video.py's defaults
    cams = video.orbit_path(camera, VIDEO_FRAMES, degrees=360.0)
    vkw = dict(spp=VIDEO_SPP, max_depth=DEPTH)
    frame_rays = W * H * VIDEO_SPP * DEPTH
    png = lambda paths: [Path(x).read_bytes() for x in paths]
    with tempfile.TemporaryDirectory(prefix="poca_video16_") as tmp:
        video.VIDEO_GRAPHS.clear()
        c0 = video.VIDEO_GRAPHS.captures
        with torch.no_grad():
            first_ms, held = first_call_cost(lambda: video.render_frame(
                video.VIDEO_GRAPHS, scene, cams[0], sky, 0, **vkw))
        kb.reset_launches()
        compiled, ms_c = timed(lambda: video.render_video(scene, cams, sky, f"{tmp}/c", seed=0,
                                                          **vkw))
        launches_c = dict(kb.LAUNCHES)
        kb.reset_launches()
        eager, ms_e = timed(lambda: video.write_frames(None, scene, cams, sky, f"{tmp}/e", seed=0,
                                                       **vkw))
        launches_e = dict(kb.LAUNCHES)
        same = png(compiled) == png(eager)
        captures = video.VIDEO_GRAPHS.captures - c0

        def frames(runner):
            with torch.no_grad():
                for i, cam in enumerate(cams):
                    video.render_frame(runner, scene, cam, sky, i, **vkw)

        _, ms_c_only = timed(lambda: frames(video.VIDEO_GRAPHS))
        _, ms_e_only = timed(lambda: frames(None))
        with torch.no_grad():
            one = lambda runner: video.render_frame(runner, scene, cams[1], sky, 1, **vkw)
            _, wall_c1 = timed(lambda: one(video.VIDEO_GRAPHS))
            busy_c1 = busy_ms(lambda: one(video.VIDEO_GRAPHS), dev)
            _, wall_e1 = timed(lambda: one(None))
            busy_e1 = busy_ms(lambda: one(None), dev)
        n = VIDEO_FRAMES
        log(f"[video16] {n} orbit frames {W}x{H} x {VIDEO_SPP} spp x d{DEPTH}, demo_scene(0): "
            f"every PNG byte-equal compiled and eager {same}; compiled {n / ms_c * 1e3:.3f} "
            f"frames/s with the sink ({ms_c:.1f} ms), {n / ms_c_only * 1e3:.3f} without "
            f"({ms_c_only / n:.2f} ms a frame, {frame_rays * n / ms_c_only / 1e6:.1f} Mrays/s); "
            f"eager {n / ms_e * 1e3:.3f} with ({ms_e:.1f} ms), {n / ms_e_only * 1e3:.3f} without "
            f"({ms_e_only / n:.2f} ms a frame); one frame compiled {wall_c1:.2f} ms wall, "
            f"{busy_c1:.2f} ms busy ({busy_c1 / wall_c1:.3f}), eager {wall_e1:.2f} ms wall, "
            f"{busy_e1:.2f} busy ({busy_e1 / wall_e1:.3f}); first call {first_ms / 1e3:.3f} s, "
            f"{held / 2**30:.3f} GiB held by the frame's graphs; captures {captures}; launches "
            f"compiled {launches_c}, eager {launches_e}; {card}")
        if not (same and captures == 3 and len(video.VIDEO_GRAPHS.keys()) == 1
                and launches_c == launches_e and launches_c["denoise"] == n
                and all(launches_c[k] > 0 for k in FORWARD_KERNELS)):
            raise AssertionError("the compiled video differs from the eager one, recaptured or "
                                 "skipped a kernel")
        video.VIDEO_GRAPHS.clear()
        mesh = make_tile_mesh([dev] * 4)
        mcams = cams[:MESH_FRAMES]
        meshed, ms_mc = timed(lambda: video.render_video(scene, mcams, sky, f"{tmp}/mc", seed=0,
                                                         mesh=mesh, **vkw))
        meshed_e, ms_me = timed(lambda: video.write_frames(None, scene, mcams, sky, f"{tmp}/me",
                                                           seed=0, mesh=mesh, **vkw))
        same_m = png(meshed) == png(meshed_e)
        tiles = tile_graphs(mesh)
        log(f"[video16] {MESH_FRAMES} frames over a virtual 2x2 mesh on one card: PNGs byte-equal "
            f"to the eager mesh video {same_m} ({ms_mc:.1f} ms compiled with its captures, "
            f"{ms_me:.1f} ms eager); tile keys {len(tiles.keys())}, tile captures "
            f"{tiles.captures}, denoise-and-pack captures {video.VIDEO_GRAPHS.captures - c0 - 3}; "
            f"{card}")
        if not (same_m and len(tiles.keys()) == 1):
            raise AssertionError("the compiled mesh video differs from the eager one")
        tiles.clear()
        video.VIDEO_GRAPHS.clear()

    # (d) the tiles: 1024^2 x 4 spp x d8 (phase 9's settings), 1x1 and 2x2 on one card
    for shape in ((1, 1), (2, 2)):
        mesh = make_tile_mesh([dev] * (shape[0] * shape[1]), shape=shape)
        runner = tile_graphs(mesh)
        tkw = dict(spp=TILE_SPP, max_depth=DEPTH)
        render_image_sharded(scene, camera, sky, mesh, seed=0, **tkw)  # warm-up and capture
        first_captures = runner.captures
        kb.reset_launches()
        got, ms_t = timed(lambda: render_image_sharded(scene, camera, sky, mesh, seed=0, **tkw))
        launches_t = dict(kb.LAUNCHES)
        kb.reset_launches()
        ref, ms_te = timed(lambda: render_tiles(None, scene, camera, sky, mesh, seed=0, **tkw))
        same = all_bits_equal(got, ref) and launches_t == dict(kb.LAUNCHES)
        moved = camera.move_forward(3.0)
        got2 = render_image_sharded(scene, moved, sky, mesh, seed=11, **tkw)
        same2 = all_bits_equal(got2, render_tiles(None, scene, moved, sky, mesh, seed=11, **tkw))
        log(f"[tiles16] render_image_sharded {W}x{H} x {TILE_SPP} spp x d{DEPTH}, mesh {shape} on "
            f"one card: compiled {ms_t:.1f} ms a frame, eager tiles {ms_te:.1f} ms; bitwise the "
            f"eager tiles {same}, launches {launches_t}; keys {len(runner.keys())} (one device, "
            f"one tile shape), captures {first_captures}; another seed and camera bitwise {same2}, "
            f"captures {runner.captures}; {card}")
        if not (same and same2 and len(runner.keys()) == 1 and runner.captures == first_captures
                and first_captures == 2):
            raise AssertionError(f"the compiled tiles of mesh {shape} differ or recaptured")
        runner.clear()

    # (e) JAX's keywords: fit with sgd and a callback that reads params["mat"]["kd"]
    small = camera.resize(256, 256)
    cfg = inverse.InverseConfig(spp=2, max_depth=4, fields=("kd",), fixed_samples=True)
    with torch.no_grad():
        target, _, _ = render_radiance(scene.with_material_params({"kd": scene.kd * 0.8}), small,
                                       sky, spp=cfg.spp, max_depth=cfg.max_depth)
    seen = []
    _, losses = inverse.fit(scene, small, sky, target, cfg, steps=3, optimizer=inverse.sgd(0.5),
                            callback=lambda s, loss, p: seen.append(p["mat"]["kd"].clone()))
    runs = []
    for _ in range(3):
        init, step = inverse.make_train_step(small, cfg, optimizer=inverse.sgd(0.5), eager=True)
        params, opt = init(scene, sky)
        run = [step(params, opt, scene, sky, target, k)[2] for k in range(3)]
        runs.append(dict(kd=params["mat"]["kd"].detach(), loss=run[2]))
        first_eager = run[0]
    got = dict(kd=seen[-1], loss=torch.tensor(losses[2], device=dev))
    dist_, bar, ok = held_to_eager(got, runs)
    first_same = losses[0] == float(first_eager)
    log(f"[api] inverse.fit(optimizer=sgd(0.5), callback reading params['mat']['kd']) on the demo "
        f"at 256^2 x {cfg.spp} spp x d{cfg.max_depth}: losses {losses}; the first bitwise the eager "
        f"step's {first_same}; after 3 steps kd and loss relative L2 from the nearest of three "
        f"eager runs {dist_:.3e}, their own spread {bar:.3e}, held {ok}; the callback saw "
        f"{len(seen)} steps; {card}")
    if not (first_same and ok and losses[2] < losses[0] and len(seen) == 3):
        raise AssertionError("fit with sgd differs from its eager step")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from cpppathtracer_tpu_torch.bench import device_label
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import (
        n_blocks, stream_compact, stream_compact_plain, stream_expand, stream_expand_plain,
    )
    from cpppathtracer_tpu_torch.inverse import InverseConfig, fit
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
    from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd, mega_bwd_plain
    from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import (
        build_tables_T, mega_trace, mega_trace_plain,
    )
    from cpppathtracer_tpu_torch.ops.fast import group_scene
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky
    from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # no float32 matmul may round to TF32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = device_label(dev)
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- phase 1: build
    t0 = time.perf_counter()
    lib_path = kb.build()
    kb.library()
    log(f"[build] {lib_path} in {time.perf_counter() - t0:.1f} s")
    ptxas = lib_path.parent / "ptxas.log"
    for line in ptxas.read_text().splitlines():
        if "registers" in line or "spill" in line or "entry" in line or line.startswith("=="):
            log(f"[ptxas] {line.strip()}")

    # ---- phase 2: each kernel against its plain version on the card
    scene = demo_scene(0).build(device=dev)
    camera = Camera.make(W, H, device=dev, **CAMERA)
    sky = torch.from_numpy(procedural_sky(256, 256)).to(dev)
    gs = group_scene(scene)
    geom = build_geom_rows(gs)
    ts, trt = build_tables_T(gs)
    r = W * H
    pix = torch.arange(r, dtype=torch.int32, device=dev)
    samp = torch.full((r,), 5, dtype=torch.int32, device=dev)
    o, d = camera.ray_gen_planar(pix, samp, 0)
    o = tuple(c.contiguous() for c in o)
    d = tuple(c.contiguous() for c in d)
    trace_args = (o, d, pix, samp, 0, geom, ts, trt)
    errs = {}
    for depth in (1, 8):
        got = mega_trace(*trace_args, counts=gs.counts, depth=depth, with_o=True)
        ref = mega_trace_plain(*trace_args, counts=gs.counts, depth=depth)
        errs[f"mega_d{depth}"] = compare_trace(got, ref, f"mega_trace depth {depth}, 1024^2 primaries")

    # the backward on the depth-8 trace's winner planes, random cotangents
    hits8 = torch.stack(got[6]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    cts = [torch.randn(r, device=dev, generator=gen) for _ in range(13)]
    bwd_args = (o, d, pix, samp, 0, ts, trt, hits8, cts)
    got_b = mega_bwd(*bwd_args, with_carry=True)
    err_bwd = compare_bwd(got_b, mega_bwd_plain(*bwd_args), "mega_bwd depth 8, 1024^2 primaries")
    carry = got_b[4]
    fwd_final = [*got[8], *got[1], *got[2], got[3]]
    same = [torch.equal(a, b) for a, b in zip([*carry[0], *carry[1], *carry[2], carry[3]], fwd_final)]
    log(f"[check] mega_bwd's forward sweep: final o, d, thru, missed bitwise equal to "
        f"mega_trace's on {sum(same)} of 10 planes")
    if not all(same):
        raise AssertionError("the backward's rebuilt carry differs from mega_trace's")

    # phase A as the main path runs it, then the compaction and phase B
    out_a = mega_trace(*trace_args, counts=gs.counts, depth=2, with_o=True)
    missed_a = out_a[3]
    payload = [pix, samp, *out_a[8], *out_a[1], *out_a[2], missed_a]
    packed, offs, n_alive = stream_compact(missed_a, payload)
    ref_c = stream_compact_plain(missed_a, payload)
    n = int(n_alive[0])
    log(f"[check] phase A leaves {n} of {r} rays alive ({n / r:.4f})")
    if not (torch.equal(offs, ref_c[1]) and torch.equal(n_alive, ref_c[2]) and
            all(torch.equal(bits(a)[:n], bits(b)[:n]) for a, b in zip(packed, ref_c[0]))):
        raise AssertionError("stream_compact differs from its plain version")

    def phase_b(planes):
        args = (tuple(planes[2:5]), tuple(planes[5:8]), planes[0], planes[1], 0, geom, ts, trt)
        kw = dict(counts=gs.counts, depth=DEPTH - 2, start_bounce=2, thru=tuple(planes[8:11]),
                  n_alive=n_alive, alive_mask=planes[11])
        return args, kw

    b_args, b_kw = phase_b(packed)
    out_b = mega_trace(*b_args, **b_kw)
    ref_b = mega_trace_plain(*b_args, **b_kw)
    errs["mega_b"] = compare_trace(out_b, ref_b, "mega_trace phase B (start 2, n_alive, alive_mask)")
    b_planes = lambda out: [*out[0], *out[1], *out[2], out[3], *out[6]]
    exp_planes = b_planes(out_b)
    exp_fills = [0.0] * 10 + [-1] * (DEPTH - 2)
    back = stream_expand(missed_a, offs, exp_planes, exp_fills)
    back_ref = stream_expand_plain(missed_a, offs, exp_planes, exp_fills)
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(back, back_ref)):
        raise AssertionError("stream_expand differs from its plain version")
    # nothing on the path reads a packed lane past n_alive: poison those lanes (NaN,
    # INT_MIN) in phase B's inputs and outputs, and phase B and the expansion give the
    # same bits
    p_args, p_kw = phase_b(poison_tail(packed, n))
    poisoned_b = mega_trace(*p_args, **p_kw)
    flat_b = lambda out: [*b_planes(out), *out[4], out[5]]
    same_b = all(torch.equal(bits(a), bits(b)) for a, b in zip(flat_b(poisoned_b), flat_b(out_b)))
    back_p = stream_expand(missed_a, offs, poison_tail(b_planes(poisoned_b), n), exp_fills)
    same_e = all(torch.equal(bits(a), bits(b)) for a, b in zip(back_p, back))
    log(f"[check] packed tail [{n}, {r}) poisoned: phase B outputs bitwise equal {same_b}, "
        f"stream_expand output bitwise equal {same_e}")
    if not (same_b and same_e):
        raise AssertionError("a kernel read a packed lane past n_alive")
    # round trip on 2^20 lanes, ~20% alive, with float and int planes
    g = torch.Generator(device=dev).manual_seed(0)
    missed_rt = (torch.rand(r, device=dev, generator=g) > 0.2).float()
    planes_rt = [torch.randn(r, device=dev, generator=g),
                 torch.randint(-2**31, 2**31 - 1, (r,), device=dev, dtype=torch.int32, generator=g)]
    pk, offs_rt, na = stream_compact(missed_rt, planes_rt)
    rt = stream_expand(missed_rt, offs_rt, pk, [7.0, -7])
    alive_rt = missed_rt == 0
    for x, y, f in zip(planes_rt, rt, (7.0, -7)):
        if not (torch.equal(x[alive_rt], y[alive_rt]) and bool((y[~alive_rt] == f).all())):
            raise AssertionError("expand(compact(x)) != x on the alive lanes")
    log(f"[check] stream_compact / stream_expand bitwise equal to plain; round trip exact "
        f"({int(na[0])} of {r} alive)")

    # ---- phase 3: the main path through the kernels
    rays = W * H * SPP * DEPTH
    render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0)  # warm-up
    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    rad, n0, t0_buf = render_radiance(scene, camera, sky, spp=SPP, max_depth=DEPTH, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    if not all(launches[k] > 0 for k in FORWARD_KERNELS) or launches["mega_bwd"]:
        raise AssertionError(f"the render skipped a kernel or ran the backward: {launches}")
    if not (torch.isfinite(rad).all() and rad.shape == (r, 3) and torch.isfinite(n0).all()):
        raise AssertionError("main path output is not finite or has the wrong shape")
    log(f"[render] 1024^2 x {SPP} spp x d{DEPTH}: {dt * 1e3:.1f} ms, "
        f"{dt * 1e3 / SPP:.3f} ms/sample, {rays / dt / 1e6:.1f} Mrays/s, launches {launches}, "
        f"mean radiance {float(rad.mean()):.5f}")

    # the same render at 1 spp, kernels vs plain path
    k1 = render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0)
    with plain_path():
        kb.reset_launches()
        p1 = render_radiance(scene, camera, sky, spp=1, max_depth=DEPTH, seed=0)
        if any(kb.LAUNCHES.values()):
            raise AssertionError("the plain path launched a kernel")
    pix_close = torch.isclose(k1[0], p1[0], rtol=1e-4, atol=1e-4).all(-1).float().mean()
    log(f"[render] kernels vs plain path at 1024^2 x 1 spp: {float(pix_close):.6f} of pixels "
        f"within 1e-4; first-hit t equal on {float((k1[2] == p1[2]).float().mean()):.6f}")
    if pix_close < 0.999:
        raise AssertionError("kernel render disagrees with the plain path")

    # ---- phase 4: progressive loop, 1280x720, 1 spp/frame, denoised
    pcam = Camera.make(1280, 720, device=dev, **CAMERA)
    prog = ProgressiveRenderer(scene, pcam, sky, RenderConfig(width=1280, height=720, max_depth=DEPTH))
    prog.step()
    torch.cuda.synchronize()
    kb.reset_launches()
    t0 = time.perf_counter()
    for _ in range(16):
        prog.step()
    frame = prog.frame()
    dt_p = time.perf_counter() - t0
    if not (np.isfinite(frame).all() and frame.shape == (720, 1280, 3)):
        raise AssertionError("progressive frame is not finite")
    if not all(kb.LAUNCHES[k] > 0 for k in FORWARD_KERNELS) or kb.LAUNCHES["mega_bwd"]:
        raise AssertionError(f"progressive loop skipped a kernel: {dict(kb.LAUNCHES)}")
    progressive_ms = dt_p * 1e3 / 16
    log(f"[progressive] 16 frames 1280x720 x1 spp x d{DEPTH} + denoise: "
        f"{progressive_ms:.2f} ms/frame, launches {dict(kb.LAUNCHES)}")

    # ---- where a sample's time goes: device time by kernel over 4 samples
    profile_device(lambda: render_radiance(scene, camera, sky, spp=4, max_depth=DEPTH, seed=0),
                   "4 samples")

    # ---- phase 5: the training path, bench.py:31-54 (fwd+bwd of sum(rad^2), grads for kd
    # and emission) at 1024^2 x 64 spp x d8
    train_step = lambda spp: loss_grads(scene, camera, sky, spp, DEPTH)
    train_step(1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    t0 = time.perf_counter()
    loss, g_kd, g_em = train_step(SPP)
    torch.cuda.synchronize()
    dt_t = time.perf_counter() - t0
    train_launches = dict(kb.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = dict(mega_trace=2 * SPP, mega_trace_aux=0, stream_compact=SPP, stream_expand=SPP,
                mega_bwd=SPP, winner_index=0, bvh_winner_index=0, denoise=0)
    if train_launches != want:
        raise AssertionError(f"training step launches {train_launches}, expected {want}")
    for name, g in (("kd", g_kd), ("emission", g_em)):
        if not torch.isfinite(g).all() or not bool((g != 0).any()):
            raise AssertionError(f"the {name} gradient is non-finite or all zero")
    log(f"[train] fwd+bwd 1024^2 x {SPP} spp x d{DEPTH}: {dt_t * 1e3:.1f} ms/step, "
        f"{rays / dt_t / 1e6:.1f} Mrays/s fwd+bwd, peak memory {peak_gib:.2f} GiB, "
        f"launches {train_launches}, loss {float(loss):.6g}, |g_kd| {float(g_kd.norm()):.6g}, "
        f"|g_emission| {float(g_em.norm()):.6g}")
    profile_device(lambda: train_step(4), "training step, 4 spp")

    # the same step at 1 spp, the kernel's backward vs the plain one
    k_step = train_step(1)
    with plain_bwd():
        kb.reset_launches()
        p_step = train_step(1)
        if kb.LAUNCHES["mega_bwd"]:
            raise AssertionError("the plain backward launched the kernel")
    for name, a, b in (("kd", k_step[1], p_step[1]), ("emission", k_step[2], p_step[2])):
        cos, ratio = cosine_and_ratio(a, b)
        log(f"[train] kernel vs plain backward, {name} gradient at 1 spp: cosine {cos:.8f}, "
            f"norm ratio {ratio:.8f}")
        if cos <= 0.9999 or abs(ratio - 1) > 1e-3:
            raise AssertionError(f"the {name} gradient differs from the plain backward's")

    # three steps of inverse.fit with InverseConfig's defaults: the target is rendered from a
    # copy of the scene whose albedos are perturbed
    cfg = InverseConfig(fixed_samples=True)
    gen_kd = torch.Generator(device=dev).manual_seed(1)
    kd_true = (scene.kd + 0.2 * torch.rand(scene.kd.shape, device=dev, generator=gen_kd) - 0.1).clamp(0, 1)
    with torch.no_grad():
        target, _, _ = render_radiance(scene.with_material_params({"kd": kd_true}), camera, sky,
                                       spp=cfg.spp, max_depth=cfg.max_depth, seed=cfg.seed)
    t0 = time.perf_counter()
    _, losses = fit(scene, camera, sky, target, cfg, steps=3)
    dt_f = time.perf_counter() - t0
    log(f"[train] inverse.fit, 3 steps at 1024^2 x {cfg.spp} spp x d{cfg.max_depth}: losses "
        f"{losses}, {dt_f * 1e3 / 3:.1f} ms/step")
    if not losses[2] < losses[0]:
        raise AssertionError("inverse.fit's loss did not fall")

    # ---- phase 6: kernel times at the main path's shapes, and bounds
    np_b = len(exp_planes)
    ops = ops_per_ray_bounce(gs.counts)
    work_a = live_ray_bounces(out_a[6])
    active_b = (torch.arange(r, device=dev) < n_alive) & (packed[11] == 0)
    work_b = live_ray_bounces(out_b[6], active_b)
    # bytes: phase A reads 8 planes and writes 14 + 3 (o) + 2 (hits) for
    # every lane; phase B reads 12 planes of the n live lanes and writes
    # 14 + 6 (hits) for every lane
    bytes_mega = 4 * (r * (8 + 19) + n * 12 + r * (14 + DEPTH - 2))
    bound_mega = max(ops * (work_a + work_b) / FP32_OPS_PER_S, bytes_mega / HBM_BYTES_PER_S)

    def time_mega(kernel, plain, extra_bytes):
        """A sample's phase A + B through the kernel and the plain version:
        (ms, plain ms, bound ms, what bounds it), the bound with `extra_bytes`
        more written than the untextured form."""
        ops_s = ops * (work_a + work_b) / FP32_OPS_PER_S
        bytes_s = (bytes_mega + extra_bytes) / HBM_BYTES_PER_S
        return (time_ms(kernel, iters=5), time_ms(plain, iters=2, warmup=1),
                max(ops_s, bytes_s) * 1e3, "operations" if ops_s > bytes_s else "bytes")

    a_kw = dict(counts=gs.counts, depth=2, with_o=True)
    ms_mega, plain_mega, _, _ = time_mega(
        lambda: (mega_trace(*trace_args, **a_kw), mega_trace(*b_args, **b_kw)),
        lambda: (mega_trace_plain(*trace_args, **a_kw), mega_trace_plain(*b_args, **b_kw)), 0)
    mega_shape, mega_blocks = mega_launch_shape(
        lambda **kw: (mega_trace(*trace_args, **a_kw, **kw), mega_trace(*b_args, **b_kw, **kw)),
        r, geom.shape[0], ts.shape[1], False)
    floor_mega = ops * (work_a + work_b) / FP32_INSTR_PER_S
    # the compaction: the miss plane and the alive lanes' payload words read, the packed
    # words, offs and n_alive written (beside it two larger counts: every payload word read;
    # every lane of every payload and packed plane moved, 4 R (2 + 2 P))
    n_pay, nb_c = len(payload), n_blocks(r)
    bytes_c = 4 * (r + 2 * n_pay * n + nb_c + 1)
    bytes_c_all = 4 * (r + n_pay * r + n_pay * n + nb_c + 1)
    bound_c = bytes_c / HBM_BYTES_PER_S
    compact = lambda: stream_compact(missed_a, payload)
    ms_c = time_ms(compact, iters=50)
    dev_c, names_c = device_ms(compact)
    host_c = host_ms(compact)
    plain_c = time_ms(lambda: stream_compact_plain(missed_a, payload), iters=3)
    stacked = torch.stack([p.view(torch.int32) for p in payload])
    alive_mask = missed_a == 0
    lib_c = time_ms(lambda: stacked[:, alive_mask], iters=50)
    lib_dev_c, lib_names_c = device_ms(lambda: stacked[:, alive_mask])
    # the expansion: the miss plane, offs and the n packed words of each plane read, every
    # output word written
    bytes_e = 4 * (r + nb_c + np_b * n + np_b * r)
    bound_e = bytes_e / HBM_BYTES_PER_S
    expand = lambda: stream_expand(missed_a, offs, exp_planes, exp_fills)
    ms_e = time_ms(expand, iters=50)
    dev_e, names_e = device_ms(expand)
    host_e = host_ms(expand)
    plain_e = time_ms(lambda: stream_expand_plain(missed_a, offs, exp_planes, exp_fills), iters=3)
    stacked_b = torch.stack([p.view(torch.int32) for p in exp_planes])[:, :n].contiguous()
    out_e = torch.zeros((np_b, r), dtype=torch.int32, device=dev)

    def lib_expand():
        out_e[:, alive_mask] = stacked_b

    lib_e = time_ms(lib_expand, iters=50)
    lib_dev_e, lib_names_e = device_ms(lib_expand)
    for what, ms, host, dev_ms, bound, lib, lib_dev, names, lib_names, plain in (
            ("stream_compact", ms_c, host_c, dev_c, bound_c, lib_c, lib_dev_c, names_c, lib_names_c,
             plain_c),
            ("stream_expand", ms_e, host_e, dev_e, bound_e, lib_e, lib_dev_e, names_e, lib_names_e,
             plain_e)):
        log(f"[kernels] {what}: wrapper {ms:.5f} ms (host enqueue {host:.5f} ms), device "
            f"{dev_ms:.5f} ms (ms a call, records kept and launches of 20 calls by name: {names}), bound "
            f"{bound * 1e3:.5f} ms ({bound / (dev_ms * 1e-3):.3f} of it on the device); library "
            f"wrapper {lib:.5f} ms, device {lib_dev:.5f} ms ({lib_names}); plain {plain:.4f} ms")
    log(f"[kernels] compaction bytes {bytes_c / 1e6:.2f} MB ({bytes_c_all / 1e6:.2f} MB with every "
        f"payload word read, {bytes_c_all / HBM_BYTES_PER_S * 1e3:.5f} ms; every lane of every plane "
        f"{4 * r * (2 + 2 * n_pay) / HBM_BYTES_PER_S * 1e3:.5f} ms); expansion {bytes_e / 1e6:.2f} MB")
    kernels = [
        dict(name="mega_trace", route="cuda", source="cpppathtracer_tpu_torch/csrc/mega_trace.cu",
             replaces="cpppathtracer_tpu/ops/pallas/mega_kernel.py:290",
             launches=launches["mega_trace"], max_abs_err=max(errs.values()), ms=ms_mega,
             plain_ms=plain_mega, bound_ms=bound_mega * 1e3, bound_by="operations",
             library_ms=None, live_ray_bounces=work_a + work_b,
             **mega_shape),
        dict(name="stream_compact", route="cuda", source="cpppathtracer_tpu_torch/csrc/compact.cu",
             replaces="cpppathtracer_tpu/ops/pallas/compact_kernel.py:231",
             launches=launches["stream_compact"], max_abs_err=0.0, ms=ms_c, plain_ms=plain_c,
             bound_ms=bound_c * 1e3, bound_by="bytes", library_ms=lib_c, device_ms=dev_c,
             library_device_ms=lib_dev_c),
        dict(name="stream_expand", route="cuda", source="cpppathtracer_tpu_torch/csrc/compact.cu",
             replaces="cpppathtracer_tpu/ops/pallas/compact_kernel.py:311",
             launches=launches["stream_expand"], max_abs_err=0.0, ms=ms_e, plain_ms=plain_e,
             bound_ms=bound_e * 1e3, bound_by="bytes", library_ms=lib_e, device_ms=dev_e,
             library_device_ms=lib_dev_e),
    ]
    log(f"[kernels] mega_trace per sample (phase A + B): {ms_mega:.3f} ms, bound {bound_mega * 1e3:.4f} ms "
        f"({ops} ops per ray-bounce, {work_a} + {work_b} live ray-bounces; its {bytes_mega / 1e6:.1f} MB "
        f"alone bound it at {bytes_mega / HBM_BYTES_PER_S * 1e3:.4f} ms), --fmad=false floor "
        f"{floor_mega * 1e3:.4f} ms; {describe_shape(mega_shape, mega_blocks, work_a + work_b)}")
    # the backward at the training step's shapes: one sample, R = 1024^2, depth 8
    live_bwd = int((hits8 >= 0).sum())
    bytes_bwd = 4 * r * (6 + 2 + 13 + DEPTH + 6)
    ops_s, bytes_s = OPS_BWD_RAY_BOUNCE * live_bwd / FP32_OPS_PER_S, bytes_bwd / HBM_BYTES_PER_S
    bound_bwd = max(ops_s, bytes_s)
    by_bwd = "operations" if ops_s > bytes_s else "bytes"
    ms_bwd = time_ms(lambda: mega_bwd(*bwd_args), iters=10)
    plain_bwd_ms = time_ms(lambda: mega_bwd_plain(*bwd_args), iters=1, warmup=1)
    n_pad = ts.shape[1]
    regs_bwd, local_bwd, per_sm_bwd = kernel_info(kb.library().poca_mega_bwd_info, n_pad, 1, 0,
                                                   n=3)
    kernels.append(
        dict(name="mega_bwd", route="cuda", source="cpppathtracer_tpu_torch/csrc/mega_bwd.cu",
             replaces="cpppathtracer_tpu/ops/pallas/mega_bwd_kernel.py:389",
             launches=train_launches["mega_bwd"], max_abs_err=err_bwd, ms=ms_bwd,
             plain_ms=plain_bwd_ms, bound_ms=bound_bwd * 1e3, bound_by=by_bwd, library_ms=None,
             registers=regs_bwd, blocks_per_sm=per_sm_bwd))
    log(f"[kernels] mega_bwd per sample: {ms_bwd:.3f} ms, bound {bound_bwd * 1e3:.4f} ms "
        f"({OPS_BWD_RAY_BOUNCE} ops per ray-bounce that hit, {live_bwd} of them, "
        f"{ops_s * 1e3:.4f} ms; its {bytes_bwd / 1e6:.1f} MB {bytes_s * 1e3:.4f} ms); "
        f"plain {plain_bwd_ms:.1f} ms; {regs_bwd} registers, {local_bwd} local bytes a thread, "
        f"{per_sm_bwd} resident blocks of 128 threads per SM")
    # ---- phase 7: textured albedo on the megakernel path
    tex_rows, tex_bwd = textured_phase(dev, scene, camera, sky, trace_args, gs, k1, time_mega,
                                       work_a + work_b, floor_mega * 1e3)
    kernels += tex_rows
    # ---- phase 8: BVH scenes through the per-bounce wavefront path, and its training step
    kernels += bvh_phase(dev, sky)
    # ---- phase 9: the entry points (command line, video, interactive, checkpoint), tile mesh
    with tempfile.TemporaryDirectory(prefix="poca_entry_") as tmp:
        entry_points_phase(dev, card, Path(tmp))
    # ---- phase 10: the row-major body (routes A and B) and the stack BVH
    route_a = rowmajor_phase(dev, sky)
    next(k for k in kernels if k["name"] == "winner_index").update(route_a)
    # ---- phase 11: the textured backward on the card, route A past one tile of rows,
    # the ladder and second split of phase B
    kernels.append(textured_bwd_phase(dev, trace_args, gs, *tex_bwd))
    ladder_phase(dev, scene, camera, sky)
    kernels.append(route_a_tiled_phase(dev, sky))
    # ---- phase 12: the bench entry point and the dense-vs-BVH crossover harness
    bench_phase(dev, card, scene, camera, sky, (loss, g_kd, g_em))
    # ---- phase 13: the video, scaling and progressive harnesses
    harness_phase(card, progressive_ms)
    # ---- phase 14: the compiled serving calls (CUDA graphs) and the denoise kernel
    kernels.append(compiled_phase(dev, card, scene, camera, sky, progressive_ms, lib_path))
    # ---- phase 15: the compiled training steps (CUDA graphs of forward, backward and Adam)
    train_compiled_phase(dev, card, scene, camera, sky, want)
    # ---- phase 16: the seed as a device word; the compiled video and tiles; JAX's keywords
    seed_graphs_phase(dev, card, scene, camera, sky, trace_args, gs, bwd_args, (ms_mega, ms_bwd))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
