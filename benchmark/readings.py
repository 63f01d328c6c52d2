"""The readings that a cell's limits are set from, on the chip.

    python benchmark/readings.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--faults] [--iterations N] [--counts N] \
        [--walk] [--search direct|expanded]

For each seed of --seeds: the cell's set-up and N iterations of its traffic
(the timed path at the cell's own sizes), then the numbers the check
compares, of the program against the float32 reference.  For each seed of
--control-seeds: the same numbers of the control, the reference computed
in bfloat16, put in the program's place; with --faults also those of each
fault the traffic kind plants in the reference (its FAULTS: a training step
that leaves half its batch out; a textured step's albedo left untextured or
its taps clamped).  --search reads the program against the
reference searching in the other form of the closest-hit tests than the
configuration's (`reference/tracer.py`).  --counts prints the work a
sample needs on the cell's inputs, as the reference counts it (live
ray-bounces and hits), for the cell's `counts` (kept there with --write):
N samples at the configured camera, or, for a traffic kind that flies the
camera (`flight_poses`), one sample at each of N cameras spread over one
period of the flight; --walk adds the BVH walk's (`roofline/bvh_walk.py`)
over the same samples (one sample without --counts).  One JSON line each on
standard output.  Not run by the benchmark's runs: it is how the limits and
counts in `workloads/<cell>.json` were read (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import inputs, registry, runner  # noqa: E402


def counts(ctx, samples: int, kind=None, walk: bool = False) -> dict:
    """Live ray-bounces and hits a sample of the cell's traffic needs, by the
    float32 reference's trace of every pixel: `samples` samples (keys 0,
    1, ...) at the configured camera, or, for a traffic kind that flies the
    camera (`flight_poses`), one sample (key 0) at each of `samples`
    cameras spread over one period of the flight.  With `walk`, also the
    BVH walk's work a sample needs (`roofline/bvh_walk.py`): the live rays
    of every bounce of the same traces, walked by the counting walk of the
    cell's BVH."""
    import torch

    from benchmark.reference import tracer

    fly = getattr(kind, "flight_poses", None)
    at = [(pose, 0) for pose in fly(ctx, samples)] if fly else [(None, k) for k in range(samples)]
    tot = {"slabs": 0, "rows": {0: 0, 1: 0, 2: 0}, "rays": 0, "bounces": 0}
    on_bounce = None
    if walk:
        bvh_walk = registry.roofline("bvh_walk")
        bvh = bvh_walk.build(inputs.arrays(ctx)[0], ctx.config.get("leaf_size"))

        def on_bounce(o, d, tmin):
            c = bvh_walk.count(bvh, o, d, tmin)
            tot["slabs"] += c["slabs"]
            tot["rows"] = {k: tot["rows"][k] + v for k, v in c["rows"].items()}
            tot["rays"] += o[0].numel()
            tot["bounces"] += 1

    s = ctx.settings
    pix = torch.arange(s["width"] * s["height"], dtype=torch.int32, device=ctx.device)
    live = hits = 0
    for pose, key in at:
        ref = inputs.reference_inputs(ctx, torch.float32, pose=pose)
        p = tracer.trace(ref["scene"], ref["camera"], ref["sky"], pix, torch.full_like(pix, key),
                         int(ctx.seed) & 0xFFFFFFFF, ctx.config["depth"], on_bounce=on_bounce)
        live += p.live_ray_bounces
        hits += p.hits
    out = {"live_ray_bounces_per_sample": live / samples, "hits_per_sample": hits / samples,
           "samples": samples, "seed": ctx.seed}
    if walk:
        out.update({
            "walk_ops_per_sample": bvh_walk.ops_of(tot) / samples,
            "walk_bytes_per_sample": (bvh_walk.BYTES_RAY * tot["rays"]
                                      + tot["bounces"] * bvh_walk.table_bytes(bvh)) / samples,
            "walk_slab_tests_per_sample": tot["slabs"] / samples,
            "walk_leaf_rows_per_sample": [tot["rows"][k] / samples for k in (0, 1, 2)],
            "nodes": int(bvh["box"].shape[0]), "leaf_size": int(bvh["leaf_size"])})
    return out


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--counts", type=int, default=0, help="samples to count the work of")
    ap.add_argument("--walk", action="store_true",
                    help="also count the BVH walk's work over the same samples (1 without --counts)")
    ap.add_argument("--reference-only", action="store_true",
                    help="the control's and the faults' readings of --control-seeds alone, "
                         "on the first card (traffic kinds that plant faults)")
    ap.add_argument("--search", choices=("direct", "expanded"), default=None,
                    help="the reference's closest-hit form, in place of the configuration's")
    ap.add_argument("--write", action="store_true",
                    help="also keep the counts in the cell's workload file")
    a = ap.parse_args(argv)
    runner.cache_env()
    wl = registry.workload(a.workload)
    kind = registry.traffic(wl["traffic"])
    seeds = lambda s: [int(v) for v in s.split(",") if v]
    emit = lambda d: print(json.dumps(d), flush=True)
    if a.reference_only:
        # the control and the faults are the reference's own: one card holds them
        devs = runner.cards(1)
        for seed in seeds(a.control_seeds):
            ctx = runner.make_context(a.workload, seed, 0.0, False, devs)
            st = kind.State()
            for control in (torch.bfloat16, *kind.FAULTS):
                t0 = time.perf_counter()
                got, judged, _ = kind.compared(st, ctx, control=control)
                name = "control" if control is torch.bfloat16 else f"fault_{control}"
                emit({"seed": seed, name: got, "judged": judged,
                      "check_s": time.perf_counter() - t0})
        return
    devs = runner.cards(int(wl["chips"]))
    if a.counts or a.walk:
        ctx = runner.make_context(a.workload, 0, 0.0, False, devs)
        t0 = time.perf_counter()
        got = counts(ctx, a.counts or 1, kind, walk=a.walk)
        emit({"counts": got, "count_s": time.perf_counter() - t0})
        if a.write:
            path = registry.BENCH_DIR / "workloads" / f"{a.workload}.json"
            w = json.loads(path.read_text())
            w["counts"].update({k: v for k, v in got.items() if k not in ("nodes", "leaf_size")})
            path.write_text(json.dumps(w, indent=1) + "\n")
    for seed in seeds(a.seeds):
        ctx = runner.make_context(a.workload, seed, 0.0, False, devs)
        if a.search:
            ctx.config["search"] = a.search
        t0 = time.perf_counter()
        st = kind.setup(ctx)
        ctx.sync()
        t1 = time.perf_counter()
        out = kind.run(st, ctx, iterations=a.iterations)
        kind.release(st, ctx)
        t2 = time.perf_counter()
        got, judged, _ = kind.compared(st, ctx)
        emit({"seed": seed, "program": got, "search": ctx.config.get("search", "direct"),
              "judged": judged, "setup_s": t1 - t0,
              "iterations": out["iterations"], "check_s": time.perf_counter() - t2})
        if seed in seeds(a.control_seeds):
            t2 = time.perf_counter()
            got, judged, _ = kind.compared(st, ctx, control=torch.bfloat16)
            emit({"seed": seed, "control": got, "judged": judged,
                  "check_s": time.perf_counter() - t2})
            for fault in (getattr(kind, "FAULTS", ()) if a.faults else ()):
                got, judged, _ = kind.compared(st, ctx, control=fault)
                emit({"seed": seed, f"fault_{fault}": got, "judged": judged})
        del st
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
