"""The skip-pointer BVH walk: its launch and its plain PyTorch version.

Counterpart of ``cpppathtracer_tpu/ops/pallas/bvh_kernel.py``
(``pallas_bvh_winner_index``).  The CUDA kernel is ``csrc/bvh.cu`` (the
walk itself is ``csrc/bvh.cuh``): persistent warps that walk 32 rays in
lock-step, each ray on its own path through the preorder nodes, over the
walk's own layout of the tables (:func:`bvh_leaf_layout`: leaf rows
grouped by type in 16-byte words, padding dropped), where the TPU walked
a whole ray tile along one path.  :func:`bvh_winner_index_plain` computes
the same function per ray on the JAX-equal tables, so the kernel and the
plain version are held bitwise on the card.

Tables (``ops/bvh.py``): node_meta i32[M, 2] (escape, leaf_id or -1),
node_aabb f32[M, 8] (min.xyz, max.xyz, pad), leaf_objs f32[L*K, 8] (cx cy
cz radius y_pos height prim_type gidx).  The result is the closest hit's
grouped index, 0 when nothing is hit: the gather epilogue recomputes t
and decides the hit.  The kernel needs tmax <= INF, which the layout's
dropped padding rows rely on (``csrc/bvh.cuh``), and every caller in the
package passes INF.

From bounce 2 the wavefront path hands the walk a live set (`live`): only
the lanes whose ray can still change are walked (:func:`walked_lanes`), and
every other lane takes the previous bounce's winner, which is what its walk
would return (the rule is argued in ``csrc/bvh.cu``'s header).
"""

from __future__ import annotations

import torch

from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.types import INF


def bvh_leaf_layout(node_meta, node_aabb, leaf_objs, leaf_size):
    """The walk kernel's layout of the tables, on their device:

    nodes f32[M, 8]: min.xyz, escape, max.xyz, leaf id (the two ints as
    float bits), two 16-byte words a node;
    leaves i32[L, 4]: each leaf's first word of `rows`, its spheres,
    cylinders and platforms;
    rows f32[W, 4]: each leaf's non-padding rows of `leaf_objs`, spheres
    first, then cylinders, then platforms, each type in table order, in
    16-byte words: a sphere (cx, cy, cz, radius), a cylinder (cx, cy, cz,
    radius) (height, 0, 0, 0), a platform (y_pos, 0, 0, 0);
    gidx i32[W]: each row's grouped index at its first word (0 elsewhere).

    ``Scene.with_bvh`` and ``refit_bvh`` build it with the tables, so a
    scene's layout always matches its tables."""
    k = leaf_size
    n_leaves = leaf_objs.shape[0] // k
    dev = leaf_objs.device
    bits = node_meta.contiguous().view(torch.float32)
    nodes = torch.cat([node_aabb[:, 0:3], bits[:, 0:1], node_aabb[:, 3:6], bits[:, 1:2]], 1)
    pt = leaf_objs[:, 6]
    # the phase of each row: sphere 0, cylinder 1, platform 2, padding 3
    phase = torch.where(pt == 0, 0, torch.where(pt == 2, 1, torch.where(pt == 1, 2, 3)))
    key = torch.arange(leaf_objs.shape[0], device=dev) // k * 4 + phase
    order = torch.sort(key, stable=True).indices
    order = order[phase[order] < 3]
    src, ph = leaf_objs[order], phase[order]
    words = torch.where(ph == 1, 2, 1)
    at = torch.cumsum(words, 0) - words  # each row's first word
    n_words = int(words.sum())
    rows = torch.zeros((n_words, 4), dtype=torch.float32, device=dev)
    rows[at] = torch.where((ph == 2)[:, None], torch.zeros_like(src[:, 0:4]), src[:, 0:4])
    rows[at[ph == 2], 0] = src[ph == 2, 4]
    rows[at[ph == 1] + 1, 0] = src[ph == 1, 5]
    gidx = torch.zeros((n_words,), dtype=torch.int32, device=dev)
    gidx[at] = src[:, 7].to(torch.int32)
    counts = torch.bincount(key, minlength=4 * n_leaves).view(n_leaves, 4)[:, :3]
    leaf_words = counts[:, 0] + 2 * counts[:, 1] + counts[:, 2]
    first = torch.cumsum(leaf_words, 0) - leaf_words
    leaves = torch.cat([first[:, None], counts], 1).to(torch.int32)
    return nodes.contiguous(), leaves.contiguous(), rows, gidx


def walked_lanes(alive, first_t):
    """The lanes a walk with the live set (alive bool[R], first_t f32[R])
    walks: those alive, and those whose path ended at bounce 0
    (first_t not < INF), whose ray may still hit from bounce 1 on."""
    return alive | ~(first_t < INF)


def bvh_winner_index(o, d, tmin, tmax, node_meta, node_aabb, leaf_objs, *, leaf_size,
                     layout=None, live=None):
    """Grouped winner index i32[R] of planar rays (o, d tuples of f32[R];
    tmin, tmax f32[R]) by the skip-pointer walk over the tables.

    `layout` is :func:`bvh_leaf_layout` of the same tables, built here when
    not given.  `live` = (alive bool[R], first_t f32[R], prev i32[R]) is the
    live set of a wavefront bounce b >= 2: alive and first_t as bounce b - 1
    left them, prev its winners.  Only :func:`walked_lanes` are walked; the
    other lanes take prev, the index their walk would return.

    CUDA tensors launch ``csrc/bvh.cu``, whose precondition is tmax <= INF:
    on a ray with a larger tmax that hits nothing it may return another
    index than the plain version (the wrapper does not check, which would
    cost a synchronisation per launch).  The returned plane is a view of a
    buffer that also holds the launch's count of walked lanes
    (:func:`walked_count`).  CPU tensors take
    :func:`bvh_winner_index_plain`."""
    dev = tmin.device
    if dev.type == "cpu":
        return bvh_winner_index_plain(o, d, tmin, tmax, node_meta, node_aabb, leaf_objs,
                                      leaf_size=leaf_size, live=live)
    if dev.type != "cuda":
        raise ValueError(f"bvh_winner_index runs on cuda or cpu tensors, got {dev}")
    r = tmin.shape[0]
    for k, t in enumerate([*o, *d, tmin, tmax]):
        kb.require(t, f"ray plane {k}", torch.float32, (r,), dev)
    if live is not None:
        for name, t, dtype in zip(("alive", "first_t", "prev"), live,
                                  (torch.bool, torch.float32, torch.int32)):
            kb.require(t, name, dtype, (r,), dev)
    m = node_meta.shape[0]
    kb.require(node_meta, "node_meta", torch.int32, (m, 2), dev)
    kb.require(node_aabb, "node_aabb", torch.float32, (m, 8), dev)
    kb.require(leaf_objs, "leaf_objs", torch.float32, (leaf_objs.shape[0], 8), dev)
    if leaf_size < 1 or leaf_objs.shape[0] % leaf_size:
        raise ValueError(f"leaf_objs has {leaf_objs.shape[0]} rows, not a multiple of {leaf_size}")
    n_leaves = leaf_objs.shape[0] // leaf_size
    nodes, leaves, rows, gidx = layout if layout is not None else bvh_leaf_layout(
        node_meta, node_aabb, leaf_objs, leaf_size)
    kb.require(nodes, "layout nodes", torch.float32, (m, 8), dev)
    kb.require(leaves, "layout leaves", torch.int32, (n_leaves, 4), dev)
    kb.require(rows, "layout rows", torch.float32, (rows.shape[0], 4), dev)
    kb.require(gidx, "layout gidx", torch.int32, (rows.shape[0],), dev)
    if any(t.data_ptr() % 16 for t in (nodes, leaves, rows)):
        raise ValueError("the walk's layout tables must be 16-byte aligned")
    # word r: the ray counter; word r + 1: the lanes walked
    out = torch.empty((r + 2,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kb.library().poca_bvh_winner_index(
            *[t.data_ptr() for t in (*o, *d, tmin, tmax, nodes, leaves, rows, gidx)],
            *map(kb.ptr, live or (None,) * 3), out.data_ptr(), r, m, n_leaves,
            kb.stream_handle(tmin),
        )
    kb.check(err, "bvh_winner_index")
    kb.LAUNCHES["bvh_winner_index"] += 1
    if live is not None:
        kb.LAUNCHES["bvh_winner_index_live"] += 1
    return out[:r]


def walked_count(gidx):
    """The count of lanes walked (an i32 tensor of one element on the card)
    by the launch that returned the winner plane `gidx`
    (:func:`bvh_winner_index` on CUDA tensors): the word after the ray
    counter in the plane's buffer."""
    r = gidx.shape[0]
    return gidx.as_strided((r + 2,), (1,), gidx.storage_offset())[r + 1:]


def _inv(v):
    return 1.0 / torch.where(v == 0.0, torch.ones_like(v), v)


def _crosses(oy, dy, y):
    return ((oy < y) & (dy > 0.0)) | ((oy > y) & (dy < 0.0))


def _leaf_t(rows, ray, tmax):
    """Candidate t f32[A, K] of the K rows of each lane's leaf (rows
    f32[A, K, 8]) against [tmin, tmax], in csrc/bvh.cuh's arithmetic;
    `ray` holds the lanes' ray values as [A, 1] columns."""
    ox, oy, oz, dx, dy, dz = (ray[c] for c in ("ox", "oy", "oz", "dx", "dy", "dz"))
    tmin = ray["tmin"]
    cx, cy, cz, rr, y0, hh = (rows[..., c] for c in range(6))
    pt = rows[..., 6].to(torch.int32)
    inf = torch.full_like(cx, INF)
    one = torch.ones_like(cx)

    # sphere
    ex, ey, ez = ox - cx, oy - cy, oz - cz
    b = ex * dx + ey * dy + ez * dz
    c = ex * ex + ey * ey + ez * ez - rr * rr
    disc = b * b - ray["a"] * c
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, disc, one))
    t_n = (-b - sq) * ray["inv_a"]
    t_f = (-b + sq) * ray["inv_a"]
    nv = has & (t_n < tmax) & (t_n > tmin)
    fv = has & (t_f < tmax) & (t_f > tmin)
    t_sph = torch.where(nv, t_n, torch.where(fv, t_f, inf))

    # platform
    t_p = (y0 - oy) * ray["inv_dy"]
    v_p = _crosses(oy, dy, y0) & (t_p < tmax) & (t_p > tmin)
    t_plat = torch.where(v_p, t_p, inf)

    # capped cylinder
    y_top = cy + hh * 0.5
    y_bot = cy - hh * 0.5

    def cap(y):
        t = (y - oy) * ray["inv_dy"]
        hx = ox + t * dx
        hz = oz + t * dz
        ex2, ez2 = hx - cx, hz - cz
        r2 = ex2 * ex2 + ez2 * ez2
        v = _crosses(oy, dy, y) & (t < tmax) & (t > tmin) & (rr > 0.0) & (r2 < rr * rr)
        return torch.where(v, t, inf)

    t_cap = torch.minimum(cap(y_top), cap(y_bot))
    bc = ex * dx + ez * dz
    cc = ex * ex + ez * ez - rr * rr
    disc_c = bc * bc - ray["ax"] * cc
    has_c = disc_c > 0.0
    sq_c = torch.sqrt(torch.where(has_c, disc_c, one))
    t_ln = (-bc - sq_c) * ray["inv_ax"]
    t_lf = (-bc + sq_c) * ray["inv_ax"]

    def lat(t):
        hy = oy + t * dy
        ok = has_c & (t < tmax) & (t > tmin) & (hy > y_bot) & (hy < y_top)
        return torch.where(ok, t, inf)

    t_cyl = torch.minimum(t_cap, torch.minimum(lat(t_ln), lat(t_lf)))
    t = torch.where(pt == 0, t_sph, torch.where(pt == 1, t_plat, torch.where(pt == 2, t_cyl, inf)))
    return t, pt


def bvh_winner_index_plain(o, d, tmin, tmax, node_meta, node_aabb, leaf_objs, *, leaf_size,
                           with_counts=False, live=None):
    """Plain PyTorch version of :func:`bvh_winner_index`, on any device: a
    lock-step walk in which every lane keeps its own node pointer.  Each
    step gathers the lanes' nodes, slab-tests them, tests the K rows of
    the leaf at lanes that overlap one, and advances each lane (escape, or
    node + 1 into an overlapping internal node).  With `live` only
    :func:`walked_lanes` walk; the other lanes return prev.

    With `with_counts` it also returns what each lane's walk tested:
    slab tests i32[R] and leaf rows by type i32[4, R] (sphere, platform,
    cylinder, padding); a lane that did not walk tested nothing."""
    r = tmin.shape[0]
    dev = tmin.device
    m, k = node_meta.shape[0], leaf_size
    if leaf_objs.shape[0] % k:
        raise ValueError(f"leaf_objs has {leaf_objs.shape[0]} rows, not a multiple of {k}")
    objs = leaf_objs.reshape(-1, k, 8)
    meta = node_meta.long()
    ray = {"ox": o[0], "oy": o[1], "oz": o[2], "dx": d[0], "dy": d[1], "dz": d[2], "tmin": tmin}
    ray["inv_dx"], ray["inv_dy"], ray["inv_dz"] = (_inv(c) for c in d)
    ray["a"] = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    ray["inv_a"] = _inv(ray["a"])
    ray["ax"] = d[0] * d[0] + d[2] * d[2]
    ray["inv_ax"] = _inv(ray["ax"])
    axes = (("ox", "dx", "inv_dx"), ("oy", "dy", "inv_dy"), ("oz", "dz", "inv_dz"))

    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    best_t = tmax.clone()
    best_i = torch.zeros((r,), dtype=torch.int32, device=dev)
    n_nodes = torch.zeros((r,), dtype=torch.int32, device=dev)
    n_rows = torch.zeros((4, r), dtype=torch.int32, device=dev)
    lanes = torch.arange(r, device=dev)
    if live is not None:
        alive, first_t, prev = live
        walk = walked_lanes(alive, first_t)
        best_i = torch.where(walk, best_i, prev)
        lanes = lanes[walk]
    while True:
        lanes = lanes[node[lanes] < m]
        if lanes.numel() == 0:
            break
        nd = node[lanes]
        box = node_aabb[nd]
        lo = torch.full((lanes.numel(),), -2.0 * INF, dtype=torch.float32, device=dev)
        hi = -lo
        for a, (ko, kd, ki) in enumerate(axes):
            oo, inv = ray[ko][lanes], ray[ki][lanes]
            t0 = (box[:, a] - oo) * inv
            t1 = (box[:, 3 + a] - oo) * inv
            free = ray[kd][lanes] == 0.0
            lo = torch.where(free, lo, torch.maximum(lo, torch.minimum(t0, t1)))
            hi = torch.where(free, hi, torch.minimum(hi, torch.maximum(t0, t1)))
        overlap = (lo <= hi) & (lo <= best_t[lanes]) & (hi >= tmin[lanes])
        leaf = meta[nd, 1]
        at_leaf = overlap & (leaf >= 0)
        if with_counts:
            n_nodes[lanes] += 1
        if bool(at_leaf.any()):
            lf = lanes[at_leaf]
            rows = objs[leaf[at_leaf]]
            bt = best_t[lf]
            t, pt = _leaf_t(rows, {key: v[lf][:, None] for key, v in ray.items()}, bt[:, None])
            t_min = t.amin(1)
            gidx = rows[..., 7].to(torch.int32)
            win = torch.where(t == t_min[:, None], gidx, torch.full_like(gidx, 2**30)).amin(1)
            better = t_min < bt
            best_t[lf] = torch.where(better, t_min, bt)
            best_i[lf] = torch.where(better, win, best_i[lf])
            if with_counts:
                for c, sel in enumerate((pt == 0, pt == 1, pt == 2, (pt < 0) | (pt > 2))):
                    n_rows[c, lf] += sel.sum(1).to(torch.int32)
        node[lanes] = torch.where(overlap & (leaf < 0), nd + 1, meta[nd, 0])
    if with_counts:
        return best_i, n_nodes, n_rows
    return best_i
