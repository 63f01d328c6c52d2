"""Wall times of two checkouts of the PyTorch/CUDA port, in interleaved pairs on one card.

    python3 scripts/torch_wall_pairs.py BASE_DIR NEW_DIR [--pairs 10] [--reps 3] [--out FILE]

Each run is a fresh process in one checkout: it imports
``cpppathtracer_tpu_torch`` from that checkout (building its kernels there at
first use) and times the end-to-end paths that ``chip_smoke.py`` drives, at
the same sizes, `reps` times each after a warm-up:

  render        ms/sample, demo_scene(0) 1024^2 x 64 spp x d8, bench camera
  progressive   ms/frame, 16 frames 1280x720 x 1 spp x d8 + denoise
  train_step    ms, fwd+bwd of sum(rad^2) at 1024^2 x 64 spp x d8, kd and emission grads
  bvh_render    ms/sample, big_scene(16384) 1024^2 x 16 spp x d8, big_camera
  bvh_progressive  ms/frame, 16 frames 1280x720 on big_scene(16384)

and prints the median of each as one JSON line.  The pairs alternate which
checkout runs first (base new, new base, ...).  The summary gives, per
metric, each side's median and interquartile range over its runs and the
number of pairs in which NEW was the faster, with the card's name and power
limit; `--out` keeps every run's numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

METRICS = ("render", "progressive", "train_step", "bvh_render", "bvh_progressive")
W = H = 1024
SPP, DEPTH, BVH_N, BVH_SPP = 64, 8, 16384, 16
CAMERA = dict(origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))


def child(reps):
    """One run, in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky
    from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig

    dev = torch.device("cuda")
    sky = torch.from_numpy(procedural_sky(256, 256)).to(dev)

    def timed(fn, per):
        fn()  # warm-up
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3 / per)
        return statistics.median(out)

    def progressive(scene, cam):
        prog = ProgressiveRenderer(scene, cam, sky, RenderConfig(width=1280, height=720,
                                                                 max_depth=DEPTH))

        def frames():
            for _ in range(16):
                prog.step()
            prog.frame()
        return frames

    scene = demo_scene(0).build(device=dev)
    camera = Camera.make(W, H, device=dev, **CAMERA)

    def render():
        with torch.no_grad():
            render_radiance(scene, camera, sky, spp=SPP, max_depth=DEPTH, seed=0)

    def train_step():
        kd = scene.kd.clone().requires_grad_()
        em = scene.emission.clone().requires_grad_()
        s = scene.with_material_params({"kd": kd, "emission": em})
        rad, _, _ = render_radiance(s, camera, sky, spp=SPP, max_depth=DEPTH, seed=0)
        torch.autograd.grad((rad * rad).sum(), (kd, em))

    got = dict(render=timed(render, SPP),
               progressive=timed(progressive(scene, Camera.make(1280, 720, device=dev, **CAMERA)), 16),
               train_step=timed(train_step, 1))
    big = big_scene(BVH_N, device=dev)
    big_cam = big_camera(BVH_N, W, H, device=dev)

    def bvh_render():
        with torch.no_grad():
            render_radiance(big, big_cam, sky, spp=BVH_SPP, max_depth=DEPTH, seed=0)

    got["bvh_render"] = timed(bvh_render, BVH_SPP)
    got["bvh_progressive"] = timed(progressive(big, big_camera(BVH_N, 1280, 720, device=dev)), 16)
    print(json.dumps(got), flush=True)


def run(checkout, reps):
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--reps", str(reps)],
                         cwd=checkout, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SystemExit(f"run in {checkout} failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def quartiles(v):
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return q[1], q[0], q[2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", nargs="?")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.reps)
    if not (args.base and args.new):
        ap.error("give the two checkouts")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {smi}", flush=True)
    runs = {"base": [], "new": []}
    for p in range(args.pairs):
        order = ("base", "new") if p % 2 == 0 else ("new", "base")
        for side in order:
            runs[side].append(run(getattr(args, side), args.reps))
            print(f"[pair {p + 1}] {side}: {json.dumps(runs[side][-1])}", flush=True)
    summary = {}
    for m in METRICS:
        b, n = [r[m] for r in runs["base"]], [r[m] for r in runs["new"]]
        summary[m] = dict(base=quartiles(b), new=quartiles(n),
                          new_faster=sum(x < y for x, y in zip(n, b)), pairs=len(b))
        print(f"[summary] {m}: base median {summary[m]['base'][0]:.3f} "
              f"({summary[m]['base'][1]:.3f}-{summary[m]['base'][2]:.3f}), new median "
              f"{summary[m]['new'][0]:.3f} ({summary[m]['new'][1]:.3f}-{summary[m]['new'][2]:.3f}), "
              f"new faster in {summary[m]['new_faster']} of {len(b)} pairs", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, runs=runs, summary=summary), f, indent=1)


if __name__ == "__main__":
    main()
