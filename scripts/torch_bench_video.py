"""Orbiting-camera video throughput of the PyTorch/CUDA port (the card's twin
of scripts/bench_video.py, whose flags and defaults it keeps).

Renders the JAX harness's orbit (bench_video.py:45-50): ``demo_scene(0)``,
the bench camera at (130, 103, 130) looking at the origin, a 256x256
procedural sky and ``video.orbit_path(camera, frames, degrees=360)``,
through ``video.render_video`` into a temporary directory: per frame the
megakernel render (``mega_trace`` twice a sample, ``stream_compact`` and
``stream_expand``), the denoiser, and the PNG encode on
``AsyncFrameSink``'s writer thread.  The JAX harness labels its path
"orbit 90deg" but renders 360 degrees; this one labels it "orbit 360deg".

Timing, as the JAX harness's (bench_video.py:52-62): frame 0 alone first
(``first_frame_s``: it holds the kernels' first-use nvcc build, so it is
not called a compile time), then the whole orbit, the clock stopping when
``render_video`` returns, with the sink closed and every PNG on disk
(``wall_s``).  Two figures the JAX harness lacks: ``render_only_wall_s``,
the same frames through ``video.render_frame`` (on the card the replays of
``render_video``'s compiled frame on ``video.VIDEO_GRAPHS``) to a
synchronize, with no sink and no PNG (``wall_s`` less this is what the
sink costs), and on the card the device busy ms of one such frame under
torch.profiler; beside them ``png_ms_per_frame``, the writer thread's work
for one frame (the copy to the host and the PNG encode of frame 0, best
of 3, on the main thread).  The run fails unless frame 0 of the warm-up
and frame 0 of the timed orbit have the same SHA-256.

Runs on the CUDA card unless --device says otherwise; without a card and
without --device it raises.  Writes its JSON to --out, never to the JAX
harness's VIDEO_r4.json or VIDEO_r5.json (TPU measurements), prints one
summary line on stdout and its progress on stderr.

Usage: python scripts/torch_bench_video.py [--frames 24] [--size 1024]
           [--spp 16] [--depth 8] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cpppathtracer_tpu_torch.bench import busy_ms, device_label  # noqa: E402
from cpppathtracer_tpu_torch.models.camera import Camera  # noqa: E402
from cpppathtracer_tpu_torch.models.scene import demo_scene  # noqa: E402
from cpppathtracer_tpu_torch.ops.texture import procedural_sky  # noqa: E402
from cpppathtracer_tpu_torch.types import resolve_device  # noqa: E402
from cpppathtracer_tpu_torch.utils.png import write_png  # noqa: E402
from cpppathtracer_tpu_torch.video import (  # noqa: E402
    VIDEO_GRAPHS,
    orbit_path,
    render_frame,
    render_video,
)

JAX_FILES = ("VIDEO_r4.json", "VIDEO_r5.json")


def build_orbit(size, frames, device):
    """The JAX harness's scene, orbit cameras and sky on `device`."""
    scene = demo_scene(seed=0).build(device=device)
    camera = Camera.make(size, size, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0),
                         device=device)
    sky = torch.from_numpy(procedural_sky(256, 256)).to(device)
    return scene, orbit_path(camera, frames, degrees=360.0), sky


def sha256_16(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "torch_video.json"))
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) in {os.path.join(REPO, f) for f in JAX_FILES}:
        raise SystemExit(f"{os.path.basename(args.out)} is the JAX harness's TPU measurement; "
                         "pass another --out")

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    scene, cams, sky = build_orbit(args.size, args.frames, dev)
    render = dict(spp=args.spp, max_depth=args.depth)

    with tempfile.TemporaryDirectory(prefix="poca_video_") as tmp:
        t0 = time.perf_counter()
        warm = render_video(scene, cams[:1], sky, os.path.join(tmp, "warm"), seed=0, **render)
        first_frame_s = time.perf_counter() - t0
        warm_sha = sha256_16(warm[0])
        print(f"[video] device={dev} frame 0 alone {first_frame_s:.3f} s", file=sys.stderr,
              flush=True)

        sync()
        t0 = time.perf_counter()
        paths = render_video(scene, cams, sky, os.path.join(tmp, "orbit"), seed=0, **render)
        wall = time.perf_counter() - t0
        checksums = [sha256_16(p) for p in paths]

    def one_frame(i):
        # render_video's frame without the sink: on the card the replay of its compiled frame
        with torch.no_grad():
            return render_frame(VIDEO_GRAPHS if on_card else None, scene, cams[i], sky, i,
                                **render)

    sync()
    t0 = time.perf_counter()
    for i in range(len(cams)):
        one_frame(i)
    sync()
    render_only = time.perf_counter() - t0
    frame0 = one_frame(0)
    sync()
    with tempfile.TemporaryDirectory(prefix="poca_png_") as tmp:
        png_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            write_png(os.path.join(tmp, "frame.png"), frame0)
            png_s.append(time.perf_counter() - t0)
    busy = busy_ms(lambda: one_frame(0), dev) if on_card else None

    rays = args.size * args.size * args.spp * args.depth * args.frames
    result = {
        "backend": dev.type,
        "device": device_label(dev),
        "config": {
            "frames": args.frames, "size": args.size, "spp": args.spp, "depth": args.depth,
            "scene": "demo (~93 objects)", "path": "orbit 360deg",
        },
        "wall_s": wall,
        "fps": args.frames / wall,
        "rays_per_s": rays / wall,
        "first_frame_s": first_frame_s,
        "render_only_wall_s": render_only,
        "png_ms_per_frame": min(png_s) * 1e3,
        "busy_ms_per_frame": busy,
        "frame_sha256_16": checksums,
        "warmup_frame0_sha256_16": warm_sha,
    }
    print(f"[video] {args.frames} frames {args.size}^2 x {args.spp} spp x d{args.depth}: "
          f"{wall:.3f} s ({result['fps']:.3f} frames/s, {result['rays_per_s'] / 1e6:.1f} Mrays/s); "
          f"render only {render_only:.3f} s; one PNG {min(png_s) * 1e3:.1f} ms; busy {busy} ms a "
          f"frame", file=sys.stderr, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    if checksums[0] != warm_sha:
        raise SystemExit(f"frame 0 of the orbit ({checksums[0]}) differs from the warm-up's "
                         f"({warm_sha})")
    print(json.dumps({"fps": round(result["fps"], 3),
                      "mrays_s": round(result["rays_per_s"] / 1e6, 1),
                      "frames": args.frames, "device": result["device"]}), flush=True)


if __name__ == "__main__":
    main()
