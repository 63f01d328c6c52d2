"""BVHs (counterpart of ``cpppathtracer_tpu/ops/bvh.py``): the skip-pointer
tables that the wavefront path's walk kernel reads, and the lock-step
stack BVH with its own walk.

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

The stack BVH (`BVH`, `build_bvh`, `refit_bvh`, `intersect_bvh`,
`intersect_auto`; JAX `ops/bvh.py:85-365`) has one object per leaf and
child links; `build_bvh` runs the same median split in the native C++
builder (``utils/native.py``) and falls back to NumPy.  `intersect_bvh`
walks it lock-step: every ray keeps its own short stack, and each step of
a Python loop pops one node per ray, slab-tests it against the ray's best
t so far, tests a leaf's object and pushes an internal node's children,
until no ray's stack holds a node.  The loop reads that condition on the
host once a step, the cost of this design on the card (the JAX package
runs the same loop as one `lax.while_loop`).  No render path uses it; the
wavefront path walks the skip-pointer tables with ``csrc/bvh.cu``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from cpppathtracer_tpu_torch.ops import intersect as dense
from cpppathtracer_tpu_torch.types import (
    BOUNCE_RAY_TMIN,
    DEFAULT_RAY_TMAX,
    INF,
    Hit,
    PrimitiveType,
)


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


# ---- the lock-step stack BVH (JAX ops/bvh.py:85-365)


def scene_to_np(scene) -> dict:
    """The scene's fields as a dict of numpy arrays (the port's copy of the
    JAX package's `reference_cpu.scene_to_np`)."""
    f = lambda a: a.detach().cpu().numpy()
    return {k: f(getattr(scene, k)) for k in (
        "prim_type", "center", "radius", "y_pos", "height", "mat_type", "kd", "emission",
        "smoothness", "reflectivity", "ior")}


@dataclasses.dataclass
class BVH:
    """Flat node tensors of a stack BVH: left, right i32[M] child nodes (-1
    at a leaf); obj_idx i32[M] the leaf's object (-1 at an internal node);
    aabb_min, aabb_max f32[M, 3]; depth, a bound on the stack depth."""

    left: torch.Tensor
    right: torch.Tensor
    obj_idx: torch.Tensor
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor
    depth: int


def build_bvh_numpy(aabb_min: np.ndarray, aabb_max: np.ndarray) -> dict:
    """The reference's median-split build (`bvh.cu:31-95`) with one object
    per leaf, nodes in preorder: each node sorts its objects by AABB
    centroid along the longest axis of their union and splits at the
    middle index.  Returns numpy arrays left, right, obj_idx, aabb_min,
    aabb_max; a scene with no active object gives one leaf that never
    hits."""
    n = aabb_min.shape[0]
    active = [i for i in range(n) if aabb_min[i, 0] <= aabb_max[i, 0]]
    order = list(active)
    cent = (aabb_min + aabb_max) * 0.5
    left, right, obj, amin, amax = [], [], [], [], []

    def divide(l, r):
        idx = len(left)
        left.append(-1)
        right.append(-1)
        obj.append(-1)
        amin.append(None)
        amax.append(None)
        if l == r - 1:
            o = order[l]
            obj[idx] = o
            amin[idx] = aabb_min[o].copy()
            amax[idx] = aabb_max[o].copy()
            return idx
        group = order[l:r]
        gmin = aabb_min[group].min(axis=0)
        gmax = aabb_max[group].max(axis=0)
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
        left[idx] = divide(l, mid)
        right[idx] = divide(mid, r)
        amin[idx] = gmin
        amax[idx] = gmax
        return idx

    if not active:
        return {
            "left": np.array([-1], np.int32),
            "right": np.array([-1], np.int32),
            "obj_idx": np.array([-1], np.int32),
            "aabb_min": np.full((1, 3), np.inf, np.float32),
            "aabb_max": np.full((1, 3), -np.inf, np.float32),
        }
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * len(active) + 100))
    try:
        divide(0, len(active))
    finally:
        sys.setrecursionlimit(old)
    return {
        "left": np.asarray(left, np.int32),
        "right": np.asarray(right, np.int32),
        "obj_idx": np.asarray(obj, np.int32),
        "aabb_min": np.stack(amin).astype(np.float32),
        "aabb_max": np.stack(amax).astype(np.float32),
    }


def build_bvh(scene) -> BVH:
    """A stack BVH over the scene's objects (in the scene's own order), on
    the scene's device: the native builder when ``utils.native`` can load
    it, else :func:`build_bvh_numpy` (the two give equal arrays;
    ``native.available()`` says which one runs).  The stack bound is
    2 ceil(log2(max(M, 2))) + 4 for M nodes: the median split is
    balanced."""
    from cpppathtracer_tpu_torch.utils import native

    amin, amax = object_aabbs(scene_to_np(scene))
    arrays = native.build_bvh(amin, amax) if native.available() else build_bvh_numpy(amin, amax)
    m = len(arrays["left"])
    dev = scene.device
    t = lambda k: torch.from_numpy(arrays[k]).to(dev)
    return BVH(left=t("left"), right=t("right"), obj_idx=t("obj_idx"), aabb_min=t("aabb_min"),
               aabb_max=t("aabb_max"), depth=2 * int(np.ceil(np.log2(max(m, 2)))) + 4)


def refit_bvh(bvh: BVH, scene) -> BVH:
    """The node boxes refit to moved objects without a new topology
    (`SceneBVH::UpdateObject` and its walk to the root, `bvh.cu:122-157`,
    for every leaf in one pass): children follow their parent in preorder,
    so one reverse sweep sets each leaf's box from its object and each
    internal node's as the union of its children's."""
    amin, amax = object_aabbs(scene_to_np(scene))
    left, right, obj = (a.cpu().numpy() for a in (bvh.left, bvh.right, bvh.obj_idx))
    node_min = bvh.aabb_min.cpu().numpy().copy()
    node_max = bvh.aabb_max.cpu().numpy().copy()
    for i in range(len(left) - 1, -1, -1):
        if obj[i] >= 0:
            node_min[i] = amin[obj[i]]
            node_max[i] = amax[obj[i]]
        else:
            kids = [c for c in (left[i], right[i]) if c >= 0]
            if kids:
                node_min[i] = node_min[kids].min(axis=0)
                node_max[i] = node_max[kids].max(axis=0)
    dev = bvh.aabb_min.device
    return dataclasses.replace(bvh, aabb_min=torch.from_numpy(node_min).to(dev),
                               aabb_max=torch.from_numpy(node_max).to(dev))


def stack_walk(scene, bvh: BVH, o, d, tmin, tmax):
    """The lock-step walk of rays o, d f32[R, 3] (tmin, tmax f32[R]) over
    `bvh`: (best t f32[R], best object i32[R] or -1, steps).  Each step
    pops one node per ray whose stack is not empty, slab-tests its box
    against the ray's best t (the tmax shrink of `bvh.cu:182-199`; a zero
    direction component leaves its slab open), tests a leaf's object
    (``intersect._object_best_t``, kept when strictly closer) and pushes an
    internal node's children.  The loop ends when no stack holds a node:
    one host read a step.  It only selects, so it runs without a graph."""
    with torch.no_grad():
        r, dev = tmin.shape[0], tmin.device
        max_stack = bvh.depth + 2
        stack = torch.zeros((r, max_stack), dtype=torch.int64, device=dev)
        top = torch.ones(r, dtype=torch.int64, device=dev)  # the root, node 0, is pushed
        best_t = tmax.clone()
        best_obj = torch.full((r,), -1, dtype=torch.int32, device=dev)
        lanes = torch.arange(max_stack, device=dev)[None, :]
        zero_d = d == 0.0
        safe_d = torch.where(zero_d, torch.ones_like(d), d)
        big = torch.full_like(d, 2.0 * INF)
        steps = 0
        while bool((top > 0).any()):
            steps += 1
            active = top > 0
            sp = torch.clamp(top - 1, min=0)
            node = torch.where(active, stack.gather(1, sp[:, None])[:, 0], torch.zeros_like(sp))
            top = torch.where(active, top - 1, top)
            t0 = (bvh.aabb_min[node] - o) / safe_d
            t1 = (bvh.aabb_max[node] - o) / safe_d
            lo = torch.where(zero_d, -big, torch.minimum(t0, t1))
            hi = torch.where(zero_d, big, torch.maximum(t0, t1))
            local_tmin = lo.amax(dim=-1)
            local_tmax = hi.amin(dim=-1)
            overlap = (local_tmin <= local_tmax) & (local_tmin <= best_t) & (local_tmax >= tmin)
            n_obj = bvh.obj_idx[node]
            is_leaf = n_obj >= 0
            oi = torch.clamp(n_obj, min=0).long()
            cand_t = dense._object_best_t(
                scene.prim_type[oi], scene.center[oi], scene.radius[oi], scene.y_pos[oi],
                scene.height[oi], o, d, tmin, best_t,
            )
            leaf_hit = active & is_leaf & overlap & (cand_t < best_t)
            best_t = torch.where(leaf_hit, cand_t, best_t)
            best_obj = torch.where(leaf_hit, n_obj, best_obj)
            push = active & overlap & ~is_leaf
            for child in (bvh.left[node].long(), bvh.right[node].long()):
                do = push & (child >= 0)
                slot = lanes == torch.clamp(top, max=max_stack - 1)[:, None]
                stack = torch.where(do[:, None] & slot, child[:, None], stack)
                top = torch.where(do, torch.clamp(top + 1, max=max_stack), top)
    return best_t, best_obj, steps


def intersect_bvh(scene, bvh: BVH, rays) -> Hit:
    """Closest hit of `rays` (any batch shape) through the lock-step stack
    walk (:func:`stack_walk`), the same Hit as ``intersect.intersect``
    gives but for a miss's pos (the origin) and normal (0).  The walk only
    selects; the winner's t and normal are computed again with gradients
    to the rays and the scene's geometry, as JAX's `intersect_bvh` does."""
    batch = rays.tmin.shape
    r = int(np.prod(batch)) if batch else 1
    flat = type(rays)(rays.origin.reshape(r, 3), rays.dir.reshape(r, 3), rays.tmin.reshape(r),
                      rays.tmax.reshape(r))
    _, best_obj, _ = stack_walk(scene, bvh, flat.origin.detach(), flat.dir.detach(),
                                flat.tmin.detach(), flat.tmax.detach())
    t, normal = dense.winner_attrs(scene, flat, best_obj.long())
    hit = best_obj >= 0
    t = torch.where(hit, t, torch.full_like(t, INF))
    pos = flat.origin + torch.where(t < INF, t, torch.zeros_like(t))[:, None] * flat.dir
    return Hit(
        t=t.reshape(batch),
        hit=hit.reshape(batch),
        pos=pos.reshape(*batch, 3),
        normal=torch.where(hit[:, None], normal, torch.zeros_like(normal)).reshape(*batch, 3),
        obj_idx=torch.where(hit, best_obj, torch.full_like(best_obj, -1)).reshape(batch),
    )


def intersect_auto(scene, rays, bvh: BVH | None = None, dense_threshold: int = 192) -> Hit:
    """The dense search (``intersect.intersect``) for a scene of at most
    `dense_threshold` objects or without a BVH, else :func:`intersect_bvh`."""
    if bvh is None or scene.num_objects <= dense_threshold:
        return dense.intersect(scene, rays)
    return intersect_bvh(scene, bvh, rays)
