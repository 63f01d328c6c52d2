"""Dense-vs-BVH crossover of the PyTorch/CUDA port (the card's twin of
scripts/bench_bvh.py, whose flags and defaults it keeps).

Times the forward render of big_scene(N) with big_camera(N) at several
scene sizes, on the CUDA card unless --device says otherwise, in three
columns:

  dense  bvh=False under POCA_MEGA=0 POCA_BVH=0: the per-bounce wavefront
         loop with the dense winner launch (csrc/winner.cu, #2);
  bvh    bvh=True under POCA_MEGA=0 POCA_BVH=1: the same loop with the
         skip-pointer walk (csrc/bvh.cu, #7) -- JAX's two columns;
  mega   bvh=False with POCA_MEGA unset: the card's default dense path,
         the megakernel (#1) with the compaction (#5/#6), which is what
         AUTO_BVH_THRESHOLD chooses between on the card.  Past the
         megakernel's shared-memory limit (about 2,320 objects) it
         records null and the error's first words, as the JAX script
         records its VMEM out-of-memory.

Each time is the best of 3 after a warm-up, with a synchronize
(bench_bvh.py:29-39); beside it, on the card, the device busy ms of one
render under torch.profiler, since these renders are host-bound.  Writes
the JSON the JAX script writes (backend, config, rows, crossover_n) plus
the device (name and power limit) and the mega columns to --out, never to
BVH_CROSSOVER.json (the JAX script's TPU measurement), and prints one
summary line on stdout.

Usage: python scripts/torch_bench_bvh.py [--res 512] [--spp 2] [--depth 4]
           [--sizes 64,256,...] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cpppathtracer_tpu_torch.bench import busy_ms, device_label  # noqa: E402
from cpppathtracer_tpu_torch.integrator import render_radiance  # noqa: E402
from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene  # noqa: E402
from cpppathtracer_tpu_torch.ops.texture import procedural_sky  # noqa: E402
from cpppathtracer_tpu_torch.types import resolve_device  # noqa: E402

# each column: whether the scene carries BVH tables, and its switches (None: unset)
MODES = {
    "dense": (False, {"POCA_MEGA": "0", "POCA_BVH": "0"}),
    "bvh": (True, {"POCA_MEGA": "0", "POCA_BVH": "1"}),
    "mega": (False, {"POCA_MEGA": None, "POCA_BVH": None}),
}


def set_switches(values):
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def time_render(render, sync, iters=3):
    """Best wall time of `iters` calls after one warm-up, in seconds."""
    render()
    sync()
    best = float("inf")
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        render()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--sizes", default="64,256,1024,1536,2048,4096,8192,16384")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "torch_bvh_crossover.json"))
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(REPO, "BVH_CROSSOVER.json"):
        raise SystemExit("BVH_CROSSOVER.json is the JAX script's TPU measurement; pass another --out")

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sky = torch.from_numpy(procedural_sky(128, 128, seed=1)).to(dev)
    rays = args.res * args.res * args.spp * args.depth
    saved = {k: os.environ.get(k) for k in ("POCA_MEGA", "POCA_BVH")}
    rows = []
    try:
        for n in [int(x) for x in args.sizes.split(",")]:
            cam = big_camera(n, args.res, args.res, device=dev)
            scenes = {False: big_scene(n, bvh=False, device=dev),
                      True: big_scene(n, bvh=True, device=dev)}
            row = {"n_objects": n}
            for mode, (bvh, switches) in MODES.items():
                set_switches(switches)

                def render(scene=scenes[bvh]):
                    with torch.no_grad():
                        return render_radiance(scene, cam, sky, spp=args.spp,
                                               max_depth=args.depth, seed=0)[0]

                try:
                    t = time_render(render, sync)
                except ValueError as e:
                    if mode != "mega" or "shared memory" not in str(e):
                        raise
                    t, row["mega_error"] = None, " ".join(str(e).split()[:12])
                row[f"{mode}_s"] = t
                row[f"{mode}_mrays_s"] = rays / t / 1e6 if t else None
                row[f"{mode}_busy_ms"] = busy_ms(render) if t and on_card else None
            row["speedup"] = row["dense_s"] / row["bvh_s"]
            row["mega_speedup"] = row["mega_s"] / row["bvh_s"] if row["mega_s"] else None
            rows.append(row)
            ms = lambda k: f"{row[k] * 1e3:9.2f} ms" if row[k] else "     null   "
            print(f"N={n:5d} dense={ms('dense_s')} bvh={ms('bvh_s')} mega={ms('mega_s')} "
                  f"dense/bvh={row['speedup']:.2f}x", file=sys.stderr, flush=True)
    finally:
        set_switches(saved)

    result = {
        "backend": dev.type,
        "device": device_label(dev),
        "config": {"res": args.res, "spp": args.spp, "depth": args.depth},
        "rows": rows,
        # the first N where the walk beats the dense launch (JAX's column) and where it
        # beats the card's default dense path, the megakernel (or the megakernel refuses)
        "crossover_n": next((r["n_objects"] for r in rows if r["speedup"] > 1.0), None),
        "mega_crossover_n": next((r["n_objects"] for r in rows
                                  if r["mega_s"] is None or r["mega_speedup"] > 1.0), None),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"crossover_n": result["crossover_n"],
                      "mega_crossover_n": result["mega_crossover_n"], "out": args.out}))


if __name__ == "__main__":
    main()
