"""Kernel #7, `bvh_winner_kernel` (csrc/bvh.cu): the closest hit of a
bounce's rays by a walk of the scene's skip-pointer BVH.

Its bound counts the work that the cell's rays need of that walk: the slab
tests of the nodes each live ray visits and the leaf rows it tests, by
type, at the FP32 operations of each (33 a slab test; 38 a sphere row, 14
a platform row, 90 a cylinder row), an FMA counted as two as the FP32 peak
counts it; and the bytes of the live rays read and their winners written
(36 a ray) and of the tables once a bounce.  Only the rays still alive at
a bounce are counted: a path that has missed needs no walk.

The counts come from the benchmark's own code: a frozen copy of the
median-split skip-pointer BVH that the program builds (the reference's
`SceneBVH::Divide`, `cuSrc/bvh.cu:31-95`, with K-object leaves, nodes in
preorder and escape indices) and a lock-step walk of it that counts what
each ray visits, run on the live rays of every bounce of the reference's
own trace of one sample, once at a stated seed (`readings.py --walk`), and
kept in the cell's workload file (`counts`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

OPS_SLAB, OPS_ROW = 33, {0: 38, 1: 14, 2: 90}
BYTES_RAY = 4 * 9
TOL = np.float32(2e-5 * 5.0)
BIG = np.float32(1e30 * 5.0)


def bound_s(work: dict, objects: dict, peaks) -> float:
    """The least seconds of the walk's work in the traced window."""
    n = work["samples"]
    ops = work["walk_ops_per_sample"] * n
    bytes_ = work["walk_bytes_per_sample"] * n
    return max(ops / peaks.FP32_FLOPS, bytes_ / peaks.HBM_BYTES_PER_S)


def _aabbs(g: dict):
    """Each object's box (the reference's `GetAABBMin/Max`): platforms and
    cylinders take a 5 * tmin tolerance in y, platforms +-5e30 in x and z."""
    n = len(g["prim_type"])
    mins, maxs = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
    for i in range(n):
        pt, c, r = int(g["prim_type"][i]), g["center"][i], abs(np.float32(g["radius"][i]))
        if pt == 0:
            mins[i], maxs[i] = c - r, c + r
        elif pt == 1:
            y = np.float32(g["y_pos"][i])
            mins[i], maxs[i] = (-BIG, y - TOL, -BIG), (BIG, y + TOL, BIG)
        else:
            h2 = np.float32(g["height"][i]) / 2
            mins[i] = (c[0] - r, c[1] - h2 - TOL, c[2] - r)
            maxs[i] = (c[0] + r, c[1] + h2 + TOL, c[2] + r)
    return mins, maxs


def build(arrays: dict, leaf_size: int | None = None) -> dict:
    """The skip-pointer BVH over the scene's objects in grouped order
    (spheres, platforms, cylinders), median split on the longest axis of
    the centroids' boxes: node boxes f32[M, 6], escape and leaf id i32[M],
    leaf rows (prim type, or -1 for padding) i32[L, K] and their objects'
    geometry.  leaf_size None: max(32, the next multiple of 8 of N / 256)."""
    from benchmark.reference.scenes import type_partition

    perm, _ = type_partition(arrays["prim_type"])
    g = {k: np.asarray(arrays[k])[perm] for k in ("prim_type", "center", "radius", "y_pos",
                                                  "height")}
    n = len(perm)
    if leaf_size is None:
        k = -(-n // 256)
        leaf_size = max(32, -(-k // 8) * 8)
    amin, amax = _aabbs(g)
    cent = (amin + amax) * 0.5
    order = list(range(n))
    nodes = []

    def divide(lo, hi):
        idx = len(nodes)
        nodes.append({"left": -1, "right": -1, "leaf": None})
        group = order[lo:hi]
        nodes[idx]["box"] = np.concatenate([amin[group].min(0), amax[group].max(0)])
        if hi - lo <= leaf_size:
            nodes[idx]["leaf"] = (lo, hi)
            return idx
        span = nodes[idx]["box"][3:] - nodes[idx]["box"][:3]
        axis = 0 if span[0] >= span[1] and span[0] >= span[2] else (1 if span[1] >= span[2] else 2)
        group.sort(key=lambda o: float(cent[o, axis]))
        order[lo:hi] = group
        mid = (lo + hi) // 2
        nodes[idx]["left"] = divide(lo, mid)
        nodes[idx]["right"] = divide(mid, hi)
        return idx

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * n + 100))
    try:
        divide(0, n)
    finally:
        sys.setrecursionlimit(old)
    m = len(nodes)
    escape = np.zeros(m, np.int64)

    def set_escape(idx, esc):
        escape[idx] = esc
        if nodes[idx]["left"] >= 0:
            set_escape(nodes[idx]["left"], nodes[idx]["right"])
            set_escape(nodes[idx]["right"], esc)

    set_escape(0, m)
    leaves = [i for i in range(m) if nodes[i]["leaf"] is not None]
    leaf_id = np.full(m, -1, np.int64)
    rows = np.full((len(leaves), leaf_size), -1, np.int64)
    geom = np.zeros((len(leaves), leaf_size, 6), np.float32)
    for li, ni in enumerate(leaves):
        leaf_id[ni] = li
        lo, hi = nodes[ni]["leaf"]
        for j, oi in enumerate(order[lo:hi]):
            rows[li, j] = int(g["prim_type"][oi])
            geom[li, j] = (*g["center"][oi], g["radius"][oi], g["y_pos"][oi], g["height"][oi])
    return {"box": np.stack([nd["box"] for nd in nodes]).astype(np.float32), "escape": escape,
            "leaf_id": leaf_id, "rows": rows, "geom": geom, "leaf_size": leaf_size}


def count(bvh: dict, o, d, tmin) -> dict:
    """Slab tests and leaf rows by type that a lock-step walk of `bvh`
    needs for rays (o, d planar float32 tensors, tmin), each ray shrinking
    its window to its nearest hit so far (the direct form of the tests)."""
    from benchmark.reference.tracer import INF, _cylinder, _platform, _sphere

    dev = o[0].device
    box = torch.as_tensor(bvh["box"], device=dev)
    escape = torch.as_tensor(bvh["escape"], device=dev)
    leaf_id = torch.as_tensor(bvh["leaf_id"], device=dev)
    rows = torch.as_tensor(bvh["rows"], device=dev)
    geom = torch.as_tensor(bvh["geom"], device=dev)
    m = box.shape[0]
    r = o[0].shape[0]
    node = torch.zeros(r, dtype=torch.int64, device=dev)
    best = torch.full((r,), INF, dtype=torch.float32, device=dev)
    slabs, by_type = 0, {0: 0, 1: 0, 2: 0}
    lanes = torch.arange(r, device=dev)
    inv = [1.0 / torch.where(c == 0.0, torch.ones_like(c), c) for c in d]
    while True:
        lanes = lanes[node[lanes] < m]
        if lanes.numel() == 0:
            break
        nd = node[lanes]
        b = box[nd]
        lo = torch.full((lanes.numel(),), -2.0 * INF, dtype=torch.float32, device=dev)
        hi = -lo
        for a in range(3):
            oo, iv = o[a][lanes], inv[a][lanes]
            t0, t1 = (b[:, a] - oo) * iv, (b[:, 3 + a] - oo) * iv
            free = d[a][lanes] == 0.0
            lo = torch.where(free, lo, torch.maximum(lo, torch.minimum(t0, t1)))
            hi = torch.where(free, hi, torch.minimum(hi, torch.maximum(t0, t1)))
        slabs += lanes.numel()
        overlap = (lo <= hi) & (lo <= best[lanes]) & (hi >= tmin[lanes])
        leaf = leaf_id[nd]
        at = overlap & (leaf >= 0)
        if bool(at.any()):
            lf, li = lanes[at], leaf[at]
            pt, gm = rows[li], geom[li]
            col = lambda v: v[lf][:, None]
            ro, rd = tuple(col(c) for c in o), tuple(col(c) for c in d)
            tl, tb = col(tmin), col(best)
            c3 = (gm[..., 0], gm[..., 1], gm[..., 2])
            t = torch.where(pt == 0, _sphere(ro, rd, c3, gm[..., 3], tl, tb)[0],
                            torch.where(pt == 1, _platform(ro, rd, gm[..., 4], tl, tb),
                                        torch.where(pt == 2, _cylinder(ro, rd, c3, gm[..., 3],
                                                                       gm[..., 5], tl, tb)[0],
                                                    torch.full_like(gm[..., 0], INF))))
            best[lf] = torch.minimum(best[lf], t.amin(1))
            for k in by_type:
                by_type[k] += int((pt == k).sum())
        node[lanes] = torch.where(overlap & (leaf < 0), nd + 1, escape[nd])
    return {"slabs": slabs, "rows": by_type}


def ops_of(counted: dict) -> int:
    return OPS_SLAB * counted["slabs"] + sum(OPS_ROW[k] * v for k, v in counted["rows"].items())


def table_bytes(bvh: dict) -> int:
    m, (nl, k) = bvh["box"].shape[0], bvh["rows"].shape
    return 4 * (m * 8 + m * 2 + nl * k * 8)
