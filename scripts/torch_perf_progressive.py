"""Progressive-loop throughput of the PyTorch/CUDA port at the reference's
operating point (the card's twin of scripts/perf_progressive.py):
1280x720, 1 spp a frame, depth 8, on ``demo_scene(0)`` with the bench
camera and a 256x256 procedural sky.

For the denoiser on and then off, builds ``renderer.ProgressiveRenderer``
with its ``RenderConfig``, takes one warm-up ``step()`` (on the card it
holds the kernels' first-use nvcc build and the capture of the frame's
CUDA graph), then times `frames` steps to a synchronize
(perf_progressive.py:33-52).  On the card each step replays that graph,
as JAX's loop runs its jitted frame program, and the JSON says so
(``"graphed": true`` when every setting's renderer captured its frame graph);
on the CPU it is the eager ``frame_step``.  Beside the mean ms a frame:
the device busy ms of one frame under torch.profiler (on the card), and
one blocking host fetch of the accumulated image, ``frame()``, timed
alone (the JAX script's docstring promises that figure; its code never
takes it).  The run fails unless the accumulated image is finite and
shaped [height, width, 3] after the timed frames.

Runs on the CUDA card unless --device says otherwise; without a card and
without --device it raises.  Prints the JAX script's text line per
setting and the progress on stderr, one summary JSON line on stdout, and
with --out writes the full JSON there.

Usage: python scripts/torch_perf_progressive.py [--frames 30]
           [--size 1280x720] [--depth 8] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cpppathtracer_tpu_torch.bench import busy_ms, device_label  # noqa: E402
from cpppathtracer_tpu_torch.models.camera import Camera  # noqa: E402
from cpppathtracer_tpu_torch.models.scene import demo_scene  # noqa: E402
from cpppathtracer_tpu_torch.ops.texture import procedural_sky  # noqa: E402
from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig  # noqa: E402
from cpppathtracer_tpu_torch.types import resolve_device  # noqa: E402


def run_setting(scene, cam, sky, depth, denoise, frames, dev):
    """One setting of the loop: a warm-up step, `frames` timed steps, the
    check, the busy ms of one more frame (card only) and one timed fetch.
    Returns (row, renderer)."""
    w, h = cam.width, cam.height
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    r = ProgressiveRenderer(scene, cam, sky,
                            RenderConfig(width=w, height=h, max_depth=depth, denoise=denoise))
    r.step()
    sync()
    t0 = time.perf_counter()
    for _ in range(frames):
        r.step()
    sync()
    dt = (time.perf_counter() - t0) / frames
    t0 = time.perf_counter()
    image = r.frame()
    fetch_ms = (time.perf_counter() - t0) * 1e3
    if not (image.shape == (h, w, 3) and np.isfinite(image).all()):
        raise SystemExit(f"denoise={denoise}: the accumulated image is not finite of shape "
                         f"{(h, w, 3)} (got {image.shape})")
    busy = busy_ms(r.step, dev) if on_card else None
    rays = w * h * depth
    print(f"[progressive {w}x{h}x1spp d{depth} denoise={denoise}] {1.0 / dt:.1f} fps, "
          f"{dt * 1e3:.1f} ms/frame, {rays / dt / 1e6:.1f} Mrays/s fwd; busy {busy} ms a frame, "
          f"frame() fetch {fetch_ms:.3f} ms", file=sys.stderr, flush=True)
    row = {"denoise": denoise, "ms_per_frame": dt * 1e3, "fps": 1.0 / dt,
           "mrays_s": rays / dt / 1e6, "busy_ms": busy, "fetch_ms": fetch_ms}
    return row, r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--size", default="1280x720", help="WIDTHxHEIGHT")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    w, h = (int(x) for x in args.size.lower().split("x"))

    dev = resolve_device(args.device)
    scene = demo_scene(seed=0).build(device=dev)
    cam = Camera.make(w, h, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device=dev)
    sky = torch.from_numpy(procedural_sky(256, 256)).to(dev)
    runs = [run_setting(scene, cam, sky, args.depth, denoise, args.frames, dev)
            for denoise in (True, False)]
    rows = [row for row, _ in runs]
    # whether every setting's frames replayed a captured CUDA graph
    graphed = all(r.graphs.captures > 0 for _, r in runs)
    label = device_label(dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"backend": dev.type, "device": label, "graphed": graphed,
                       "config": {"width": w, "height": h, "spp_per_frame": 1,
                                  "depth": args.depth, "frames": args.frames},
                       "rows": rows}, f, indent=2)
    print(json.dumps({"progressive": [{k: r[k] for k in ("denoise", "ms_per_frame", "fps",
                                                         "busy_ms")} for r in rows],
                      "device": label, "graphed": graphed}), flush=True)


if __name__ == "__main__":
    main()
