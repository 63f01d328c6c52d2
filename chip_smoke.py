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
with POCA_BVH=0 POCA_MEGA=0) through the kernels, times each kernel
beside its bound, its plain version and a PyTorch library yardstick (the
walk also per bounce; the walk and the backward with their registers and
resident blocks per SM), and prints:
  - the card's name and power limit (nvidia-smi);
  - one JSON line {"kernels": [...]};
  - as the last line, {"ok": true, "device": {...}}.
Any failed phase raises, and the script exits non-zero.  Without a CUDA
card it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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


def device_ms(fn, iters=20):
    """Device time per call of fn() under torch.profiler: the summed device
    time of the kernels, memsets and copies it issues over `iters` calls,
    and the time per call of each by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device time")
    return (sum(e.device_time_total for e in events) / 1e3 / iters,
            {e.key[:40]: round(e.device_time_total / 1e3 / iters, 5) for e in events})


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


def bvh_phase(dev, sky):
    """The BVH path: the walk and the dense launch against their plain
    versions, BVH vs dense renders, the big_scene(16384) render and
    progressive loop, a profile, and the two kernels' rows."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import bvh_winner_index, bvh_winner_index_plain
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
        build_geom_rows, winner_index, winner_index_plain,
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

    # 8. kernel rows.  The walk per sample: the 8 per-bounce launches of sample 0 on its
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
    log(f"[kernels] winner_index, 1024^2 primaries of big_scene(4096): {ms_w:.3f} ms, bound "
        f"{max(ops_ws, bytes_ws) * 1e3:.4f} ms ({ops_w:.4g} ops {ops_ws * 1e3:.4f} ms; "
        f"{bytes_w / 1e6:.1f} MB {bytes_ws * 1e3:.4f} ms); plain {plain_w:.1f} ms")
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
             bound_ms=max(ops_ws, bytes_ws) * 1e3, bound_by=by(ops_ws, bytes_ws), library_ms=None),
    ]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
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
    log(f"[progressive] 16 frames 1280x720 x1 spp x d{DEPTH} + denoise: "
        f"{dt_p * 1e3 / 16:.2f} ms/frame, launches {dict(kb.LAUNCHES)}")

    # ---- where a sample's time goes: device time by kernel over 4 samples
    profile_device(lambda: render_radiance(scene, camera, sky, spp=4, max_depth=DEPTH, seed=0),
                   "4 samples")

    # ---- phase 5: the training path, bench.py:31-54 (fwd+bwd of sum(rad^2), grads for kd
    # and emission) at 1024^2 x 64 spp x d8
    def train_step(spp):
        kd = scene.kd.clone().requires_grad_()
        em = scene.emission.clone().requires_grad_()
        s = scene.with_material_params({"kd": kd, "emission": em})
        rad, _, _ = render_radiance(s, camera, sky, spp=spp, max_depth=DEPTH, seed=0)
        loss = (rad * rad).sum()
        g_kd, g_em = torch.autograd.grad(loss, (kd, em))
        return loss.detach(), g_kd, g_em

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
    want = dict(mega_trace=2 * SPP, stream_compact=SPP, stream_expand=SPP, mega_bwd=SPP,
                winner_index=0, bvh_winner_index=0)
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
    a_kw = dict(counts=gs.counts, depth=2, with_o=True)
    ms_mega = time_ms(lambda: (mega_trace(*trace_args, **a_kw), mega_trace(*b_args, **b_kw)), iters=5)
    plain_mega = time_ms(lambda: (mega_trace_plain(*trace_args, **a_kw), mega_trace_plain(*b_args, **b_kw)),
                         iters=2, warmup=1)
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
            f"{dev_ms:.5f} ms ({names}), bound {bound * 1e3:.5f} ms ({bound / (dev_ms * 1e-3):.3f} "
            f"of it on the device); library wrapper {lib:.5f} ms, device {lib_dev:.5f} ms "
            f"({lib_names}); plain {plain:.4f} ms")
    log(f"[kernels] compaction bytes {bytes_c / 1e6:.2f} MB ({bytes_c_all / 1e6:.2f} MB with every "
        f"payload word read, {bytes_c_all / HBM_BYTES_PER_S * 1e3:.5f} ms; every lane of every plane "
        f"{4 * r * (2 + 2 * n_pay) / HBM_BYTES_PER_S * 1e3:.5f} ms); expansion {bytes_e / 1e6:.2f} MB")
    kernels = [
        dict(name="mega_trace", route="cuda", source="cpppathtracer_tpu_torch/csrc/mega_trace.cu",
             replaces="cpppathtracer_tpu/ops/pallas/mega_kernel.py:290",
             launches=launches["mega_trace"], max_abs_err=max(errs.values()), ms=ms_mega,
             plain_ms=plain_mega, bound_ms=bound_mega * 1e3, bound_by="operations",
             library_ms=None),
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
        f"alone bound it at {bytes_mega / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    # the backward at the training step's shapes: one sample, R = 1024^2, depth 8
    live_bwd = int((hits8 >= 0).sum())
    bytes_bwd = 4 * r * (6 + 2 + 13 + DEPTH + 6)
    ops_s, bytes_s = OPS_BWD_RAY_BOUNCE * live_bwd / FP32_OPS_PER_S, bytes_bwd / HBM_BYTES_PER_S
    bound_bwd = max(ops_s, bytes_s)
    by_bwd = "operations" if ops_s > bytes_s else "bytes"
    ms_bwd = time_ms(lambda: mega_bwd(*bwd_args), iters=10)
    plain_bwd_ms = time_ms(lambda: mega_bwd_plain(*bwd_args), iters=1, warmup=1)
    n_pad = ts.shape[1]
    regs_bwd, local_bwd, per_sm_bwd = kernel_info(kb.library().poca_mega_bwd_info, n_pad, 1, n=3)
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
    # ---- phase 7: BVH scenes through the per-bounce wavefront path
    kernels += bvh_phase(dev, sky)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
