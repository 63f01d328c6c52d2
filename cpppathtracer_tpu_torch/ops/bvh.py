"""Skip-pointer BVH tables, built on the host in NumPy (counterpart of the
skip-pointer half of ``cpppathtracer_tpu/ops/bvh.py``).

The build reproduces the reference's median split (`SceneBVH::Divide`,
`cuSrc/bvh.cu:31-95`) with K-object leaves: nodes in preorder, each with
an ESCAPE index (the next node in preorder outside its subtree), so a
traversal needs no stack.  Object AABBs follow `Object::GetAABBMin/Max`
(`cuSrc/object.cu:134-170`): the BOUNCE_RAY_TMIN*5 y tolerance on
platforms and cylinders, and the platform's +-DEFAULT_RAY_TMAX*5 x/z
extent.  Refit (`SceneBVH::UpdateObject`, `bvh.cu:122-157`) rewrites the
leaf rows and the AABBs of moved geometry and keeps the topology.

The tables (what ``csrc/bvh.cu`` and its plain version read):
  node_meta i32[M, 2]   (escape, leaf_id or -1)
  node_aabb f32[M, 8]   (min.xyz, max.xyz, pad, pad)
  leaf_objs f32[L*K, 8] (cx, cy, cz, radius, y_pos, height, prim_type
                         (-1 pad), grouped object index)

The lock-step stack traversal of the JAX package (`BVH`, `build_bvh`,
`intersect_bvh`, `intersect_auto`) and its native builder are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import sys

import numpy as np

from cpppathtracer_tpu_torch.types import BOUNCE_RAY_TMIN, DEFAULT_RAY_TMAX, PrimitiveType


def object_aabbs(scene_np) -> tuple[np.ndarray, np.ndarray]:
    """AABB (min, max) per object, f32[N, 3] each, from a dict of numpy
    arrays prim_type, center, radius, y_pos, height."""
    n = len(scene_np["prim_type"])
    tol = np.float32(BOUNCE_RAY_TMIN * 5.0)
    big = np.float32(DEFAULT_RAY_TMAX * 5.0)
    mins = np.zeros((n, 3), np.float32)
    maxs = np.zeros((n, 3), np.float32)
    for i in range(n):
        pt = int(scene_np["prim_type"][i])
        c = scene_np["center"][i]
        r = abs(np.float32(scene_np["radius"][i]))
        if pt == PrimitiveType.SPHERE:
            mins[i] = c - r
            maxs[i] = c + r
        elif pt == PrimitiveType.PLATFORM:
            y = np.float32(scene_np["y_pos"][i])
            mins[i] = (-big, y - tol, -big)
            maxs[i] = (big, y + tol, big)
        elif pt == PrimitiveType.CYLINDER:
            h2 = np.float32(scene_np["height"][i]) / 2
            mins[i] = (c[0] - r, c[1] - h2 - tol, c[2] - r)
            maxs[i] = (c[0] + r, c[1] + h2 + tol, c[2] + r)
        else:  # inactive padding: an empty box that nothing overlaps
            mins[i] = (np.inf, np.inf, np.inf)
            maxs[i] = (-np.inf, -np.inf, -np.inf)
    return mins, maxs


def build_skip_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray, leaf_size: int = 8):
    """Median-split BVH with `leaf_size`-object leaves, preorder nodes and
    escape indices.  Each node splits its objects, sorted by AABB centroid
    along the longest axis of their union, at the middle index.

    Returns a dict: node_aabb f32[M, 8], node_meta i32[M, 2] (escape, -1;
    skip_bvh_tables fills the leaf ids), leaf_objs f32[L*K, 8] (padding
    rows only), order i32[n_active] (the leaf-contiguous object order),
    leaves (the node index of each leaf), leaf_size and nodes."""
    n = aabb_min.shape[0]
    active = [i for i in range(n) if aabb_min[i, 0] <= aabb_max[i, 0]]
    order = list(active)
    cent = (aabb_min + aabb_max) * 0.5
    nodes = []  # dicts: min, max, left, right, leaf (l, r) or None

    def divide(l, r):
        idx = len(nodes)
        nodes.append({"left": -1, "right": -1, "leaf": None})
        group = order[l:r]
        gmin = aabb_min[group].min(axis=0)
        gmax = aabb_max[group].max(axis=0)
        nodes[idx]["min"] = gmin
        nodes[idx]["max"] = gmax
        if r - l <= leaf_size:
            nodes[idx]["leaf"] = (l, r)
            return idx
        span = gmax - gmin
        if span[0] >= span[1] and span[0] >= span[2]:
            axis = 0
        elif span[1] >= span[2]:
            axis = 1
        else:
            axis = 2
        group.sort(key=lambda o: float(cent[o, axis]))
        order[l:r] = group
        mid = (l + r) // 2
        nodes[idx]["left"] = divide(l, mid)
        nodes[idx]["right"] = divide(mid, r)
        return idx

    if active:
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * len(active) + 100))
        try:
            divide(0, len(active))
        finally:
            sys.setrecursionlimit(old)
    else:
        nodes.append({
            "left": -1, "right": -1, "leaf": (0, 0),
            "min": np.full(3, np.inf, np.float32),
            "max": np.full(3, -np.inf, np.float32),
        })

    m = len(nodes)
    escape = np.zeros(m, np.int32)

    def set_escape(idx, esc):
        escape[idx] = esc
        li, ri = nodes[idx]["left"], nodes[idx]["right"]
        if li >= 0:
            set_escape(li, ri)  # the left subtree exits into the right one
            set_escape(ri, esc)

    set_escape(0, m)

    leaves = [i for i in range(m) if nodes[i]["leaf"] is not None]
    k = leaf_size
    leaf_objs = np.zeros((max(len(leaves), 1) * k, 8), np.float32)
    leaf_objs[:, 6] = -1.0  # padding rows: prim_type -1 never hits
    node_meta = np.full((m, 2), -1, np.int32)
    node_meta[:, 0] = escape
    node_aabb = np.zeros((m, 8), np.float32)
    for i, nd in enumerate(nodes):
        node_aabb[i, 0:3] = nd["min"]
        node_aabb[i, 3:6] = nd["max"]
    return {
        "node_aabb": node_aabb,
        "node_meta": node_meta,
        "leaf_objs": leaf_objs,
        "order": np.asarray(order, np.int32),
        "leaves": leaves,
        "leaf_size": k,
        "nodes": nodes,
    }


def skip_bvh_tables(center, radius, y_pos, height, prim_type, leaf_size: int = 8):
    """Build the skip-pointer BVH over GROUPED object arrays (numpy) and
    fill the leaf rows with the grouped indices the winner kernels return,
    so the gather epilogue reads the same records as on the dense path.
    Returns node_aabb, node_meta, leaf_objs and leaf_size."""
    sc = {
        "prim_type": np.asarray(prim_type),
        "center": np.asarray(center, np.float32),
        "radius": np.asarray(radius, np.float32),
        "y_pos": np.asarray(y_pos, np.float32),
        "height": np.asarray(height, np.float32),
    }
    amin, amax = object_aabbs(sc)
    built = build_skip_bvh(amin, amax, leaf_size)
    k = built["leaf_size"]
    order = built["order"]
    leaf_objs = built["leaf_objs"]
    for leaf_id, node_i in enumerate(built["leaves"]):
        l, r = built["nodes"][node_i]["leaf"]
        built["node_meta"][node_i, 1] = leaf_id
        for j, oi in enumerate(order[l:r]):
            row = leaf_id * k + j
            leaf_objs[row, 0:3] = sc["center"][oi]
            leaf_objs[row, 3] = sc["radius"][oi]
            leaf_objs[row, 4] = sc["y_pos"][oi]
            leaf_objs[row, 5] = sc["height"][oi]
            leaf_objs[row, 6] = float(sc["prim_type"][oi])
            leaf_objs[row, 7] = float(oi)
    return {
        "node_aabb": built["node_aabb"],
        "node_meta": built["node_meta"],
        "leaf_objs": leaf_objs,
        "leaf_size": k,
    }


def refit_skip_tables(node_meta, node_aabb, leaf_objs, leaf_size,
                      center, radius, y_pos, height, prim_type):
    """Refit the tables to moved geometry without a rebuild: rewrite every
    leaf row's geometry from its stored grouped index (column 7), then one
    reverse-preorder pass sets each leaf's AABB from its objects and each
    internal node's as the union of its children (left = i + 1, right =
    escape(left)).  The topology is unchanged, so winners equal a full
    rebuild's; only the pruning can degrade as objects drift.  Returns
    (node_aabb, leaf_objs) as new numpy arrays."""
    node_meta = np.asarray(node_meta)
    leaf_objs = np.array(leaf_objs, np.float32, copy=True)
    node_aabb = np.array(node_aabb, np.float32, copy=True)
    center = np.asarray(center, np.float32)
    radius = np.asarray(radius, np.float32)
    y_pos = np.asarray(y_pos, np.float32)
    height = np.asarray(height, np.float32)

    valid = leaf_objs[:, 6] >= 0
    oi = leaf_objs[:, 7].astype(np.int64)
    oi_v = oi[valid]
    leaf_objs[valid, 0:3] = center[oi_v]
    leaf_objs[valid, 3] = radius[oi_v]
    leaf_objs[valid, 4] = y_pos[oi_v]
    leaf_objs[valid, 5] = height[oi_v]

    amin, amax = object_aabbs({
        "prim_type": np.asarray(prim_type), "center": center, "radius": radius,
        "y_pos": y_pos, "height": height,
    })
    k = leaf_size
    for i in range(node_meta.shape[0] - 1, -1, -1):
        leaf_id = int(node_meta[i, 1])
        if leaf_id >= 0:
            rows = slice(leaf_id * k, (leaf_id + 1) * k)
            rv = valid[rows]
            if rv.any():
                ids = oi[rows][rv]
                node_aabb[i, 0:3] = amin[ids].min(axis=0)
                node_aabb[i, 3:6] = amax[ids].max(axis=0)
            else:
                node_aabb[i, 0:3] = np.inf
                node_aabb[i, 3:6] = -np.inf
        else:
            left = i + 1
            right = int(node_meta[left, 0])  # escape(left) is the right child
            node_aabb[i, 0:3] = np.minimum(node_aabb[left, 0:3], node_aabb[right, 0:3])
            node_aabb[i, 3:6] = np.maximum(node_aabb[left, 3:6], node_aabb[right, 3:6])
    return node_aabb, leaf_objs
