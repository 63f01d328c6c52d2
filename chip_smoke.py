"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cpppathtracer_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, drives the main path
(``render_radiance`` on ``demo_scene(0)`` at 1024^2 x 64 spp x depth 8 with
the bench camera, then 16 progressive 1280x720 frames with the denoiser)
through the kernels, times each kernel beside its bound, its plain version
and a PyTorch library yardstick, and prints:
  - the card's name and power limit (nvidia-smi);
  - one JSON line {"kernels": [...]};
  - as the last line, {"ok": true, "device": {...}}.
Any failed phase raises, and the script exits non-zero.  Without a CUDA
card it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

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

W = H = 1024
SPP, DEPTH = 64, 8
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.cuda import build as kb
    from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import (
        stream_compact, stream_compact_plain, stream_expand, stream_expand_plain,
    )
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
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
        if "registers" in line or "spill" in line or line.startswith("=="):
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
        got = mega_trace(*trace_args, counts=gs.counts, depth=depth)
        ref = mega_trace_plain(*trace_args, counts=gs.counts, depth=depth)
        errs[f"mega_d{depth}"] = compare_trace(got, ref, f"mega_trace depth {depth}, 1024^2 primaries")

    # phase A as the main path runs it, then the compaction and phase B
    out_a = mega_trace(*trace_args, counts=gs.counts, depth=2, with_o=True)
    missed_a = out_a[3]
    payload = [pix, samp, *out_a[8], *out_a[1], *out_a[2], missed_a]
    fills = [-1, -1] + [0.0] * 9 + [1.0]
    packed, pos, n_alive = stream_compact(missed_a, payload, fills)
    ref_c = stream_compact_plain(missed_a, payload, fills)
    n = int(n_alive[0])
    log(f"[check] phase A leaves {n} of {r} rays alive ({n / r:.4f})")
    for a, b in zip(packed + [pos, n_alive], ref_c[0] + [ref_c[1], ref_c[2]]):
        if not torch.equal(a, b):
            raise AssertionError("stream_compact differs from its plain version")
    b_args = (tuple(packed[2:5]), tuple(packed[5:8]), packed[0], packed[1], 0, geom, ts, trt)
    b_kw = dict(counts=gs.counts, depth=DEPTH - 2, start_bounce=2, thru=tuple(packed[8:11]),
                n_alive=n_alive, alive_mask=packed[11])
    out_b = mega_trace(*b_args, **b_kw)
    ref_b = mega_trace_plain(*b_args, **b_kw)
    errs["mega_b"] = compare_trace(out_b, ref_b, "mega_trace phase B (start 2, n_alive, alive_mask)")
    exp_planes = [*out_b[0], *out_b[1], *out_b[2], out_b[3], *out_b[6]]
    exp_fills = [0.0] * 10 + [-1] * (DEPTH - 2)
    back = stream_expand(missed_a, pos, exp_planes, exp_fills, n_alive)
    back_ref = stream_expand_plain(missed_a, pos, exp_planes, exp_fills, n_alive)
    for a, b in zip(back, back_ref):
        if not torch.equal(a, b):
            raise AssertionError("stream_expand differs from its plain version")
    # round trip on 2^20 lanes, ~20% alive, with float and int planes
    g = torch.Generator(device=dev).manual_seed(0)
    missed_rt = (torch.rand(r, device=dev, generator=g) > 0.2).float()
    planes_rt = [torch.randn(r, device=dev, generator=g),
                 torch.randint(-2**31, 2**31 - 1, (r,), device=dev, dtype=torch.int32, generator=g)]
    pk, ps, na = stream_compact(missed_rt, planes_rt, [0.0, 0])
    rt = stream_expand(missed_rt, ps, pk, [7.0, -7], na)
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
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"main path skipped a kernel: {launches}")
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
    if not all(v > 0 for v in kb.LAUNCHES.values()):
        raise AssertionError(f"progressive loop skipped a kernel: {dict(kb.LAUNCHES)}")
    log(f"[progressive] 16 frames 1280x720 x1 spp x d{DEPTH} + denoise: "
        f"{dt_p * 1e3 / 16:.2f} ms/frame, launches {dict(kb.LAUNCHES)}")

    # ---- where a sample's time goes: device time by kernel over 4 samples
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_radiance(scene, camera, sky, spp=4, max_depth=DEPTH, seed=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel events only: an aten op's own device time repeats its kernels'
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: e.device_time_total
    events.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    log(f"[profile] 4 samples: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.3f}), {sum(e.count for e in events)} device ops")
    for e in events[:12]:
        log(f"[profile] {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")

    # ---- phase 5: kernel times at the main path's shapes, and bounds
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
    n_pay = len(payload)
    bound_c = 4 * r * (1 + n_pay + n_pay + 1) / HBM_BYTES_PER_S
    ms_c = time_ms(lambda: stream_compact(missed_a, payload, fills))
    plain_c = time_ms(lambda: stream_compact_plain(missed_a, payload, fills), iters=3)
    stacked = torch.stack([p.view(torch.int32) for p in payload])
    alive_mask = missed_a == 0
    lib_c = time_ms(lambda: stacked[:, alive_mask])
    bound_e = 4 * (r + n + np_b * n + np_b * r) / HBM_BYTES_PER_S
    ms_e = time_ms(lambda: stream_expand(missed_a, pos, exp_planes, exp_fills, n_alive))
    plain_e = time_ms(lambda: stream_expand_plain(missed_a, pos, exp_planes, exp_fills, n_alive), iters=3)
    stacked_b = torch.stack([p.view(torch.int32) for p in exp_planes])[:, :n].contiguous()
    out_e = torch.zeros((np_b, r), dtype=torch.int32, device=dev)

    def lib_expand():
        out_e[:, alive_mask] = stacked_b

    lib_e = time_ms(lib_expand)
    kernels = [
        dict(name="mega_trace", route="cuda", source="cpppathtracer_tpu_torch/csrc/mega_trace.cu",
             replaces="cpppathtracer_tpu/ops/pallas/mega_kernel.py:290",
             launches=launches["mega_trace"], max_abs_err=max(errs.values()), ms=ms_mega,
             plain_ms=plain_mega, bound_ms=bound_mega * 1e3, bound_by="operations",
             library_ms=None),
        dict(name="stream_compact", route="cuda", source="cpppathtracer_tpu_torch/csrc/compact.cu",
             replaces="cpppathtracer_tpu/ops/pallas/compact_kernel.py:231",
             launches=launches["stream_compact"], max_abs_err=0.0, ms=ms_c, plain_ms=plain_c,
             bound_ms=bound_c * 1e3, bound_by="bytes", library_ms=lib_c),
        dict(name="stream_expand", route="cuda", source="cpppathtracer_tpu_torch/csrc/compact.cu",
             replaces="cpppathtracer_tpu/ops/pallas/compact_kernel.py:311",
             launches=launches["stream_expand"], max_abs_err=0.0, ms=ms_e, plain_ms=plain_e,
             bound_ms=bound_e * 1e3, bound_by="bytes", library_ms=lib_e),
    ]
    log(f"[kernels] mega_trace per sample (phase A + B): {ms_mega:.3f} ms, bound {bound_mega * 1e3:.4f} ms "
        f"({ops} ops per ray-bounce, {work_a} + {work_b} live ray-bounces; its {bytes_mega / 1e6:.1f} MB "
        f"alone bound it at {bytes_mega / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
