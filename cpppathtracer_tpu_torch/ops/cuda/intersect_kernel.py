"""Closest-hit winner search: the geometry rows its kernel reads, the
standalone launch and its plain PyTorch version.

Counterpart of ``cpppathtracer_tpu/ops/pallas/intersect_kernel.py``
(``pallas_winner_index_planar``, ``pallas_winner_index_v``,
``pallas_winner_index``: one function in three TPU layouts).  The CUDA form
is the ``__device__`` function ``poca_winner_search`` in ``csrc/winner.cuh``,
inlined by the megakernel (``csrc/mega_trace.cu``) and launched alone by
``csrc/winner.cu`` (:func:`winner_index`) for the per-bounce wavefront
path.
"""

from __future__ import annotations

import torch

from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.types import INF

# The shared memory one block may opt into on sm_90 (227 KB); the launch
# stages all geometry rows there.
WINNER_SMEM_MAX = 232448


def ceil8(n: int) -> int:
    return -(-n // 8) * 8


def winner_index(counts, o, d, tmin, tmax, geom):
    """Dense grouped winner index i32[R] for planar rays (o, d tuples of
    f32[R]; tmin, tmax f32[R]) over `geom` (:func:`build_geom_rows`);
    0 where nothing is hit.

    CUDA tensors launch ``csrc/winner.cu``; CPU tensors take
    :func:`winner_index_plain`.  A scene whose rows exceed the shared
    memory of one block raises ValueError on either device, so that a CPU
    run meets the card's limit."""
    dev = tmin.device
    n_rep = geom.shape[0]
    if 32 * n_rep > WINNER_SMEM_MAX:
        raise ValueError(
            f"winner_index stages {n_rep} geometry rows ({32 * n_rep} bytes) in shared "
            f"memory; one block holds at most {WINNER_SMEM_MAX} bytes "
            f"({WINNER_SMEM_MAX // 32} rows): give the scene BVH tables"
        )
    if dev.type == "cpu":
        return winner_index_plain(counts, o, d, tmin, tmax, geom)
    if dev.type != "cuda":
        raise ValueError(f"winner_index runs on cuda or cpu tensors, got {dev}")
    r = tmin.shape[0]
    n_s, n_p, n_c = counts
    f32 = torch.float32
    for k, t in enumerate([*o, *d, tmin, tmax]):
        kb.require(t, f"ray plane {k}", f32, (r,), dev)
    kb.require(geom, "geom", f32, (n_rep, 8), dev)
    if n_rep < ceil8(n_s) + ceil8(n_p) + ceil8(n_c):
        raise ValueError("geom has fewer rows than the counts")
    out = torch.empty((r,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kb.library().poca_winner_index(
            *[t.data_ptr() for t in (*o, *d, tmin, tmax)], geom.data_ptr(), out.data_ptr(),
            r, n_s, n_p, n_c, n_rep, kb.stream_handle(tmin),
        )
    kb.check(err, "winner_index")
    kb.LAUNCHES["winner_index"] += 1
    return out


def build_geom_rows(gs):
    """The grouped geometry as f32[N_rep, 8] rows (cx cy cz radius y_pos
    height |c|^2-r^2 cx^2+cz^2-r^2), each type group at an 8-row aligned
    offset [S pad | P pad | C pad]."""
    n_s, n_p, n_c = gs.counts
    ns8, np8, nc8 = ceil8(n_s), ceil8(n_p), ceil8(n_c)
    n_rep = max(8, ns8 + np8 + nc8)
    c = gs.center
    r2 = gs.radius * gs.radius
    cc = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r2
    cc2 = c[:, 0] * c[:, 0] + c[:, 2] * c[:, 2] - r2
    fields = torch.stack(
        [c[:, 0], c[:, 1], c[:, 2], gs.radius, gs.y_pos, gs.height, cc, cc2], dim=1
    )
    geom = torch.zeros((n_rep, 8), dtype=torch.float32, device=c.device)
    geom[0:n_s] = fields[0:n_s]
    geom[ns8: ns8 + n_p] = fields[n_s: n_s + n_p]
    geom[ns8 + np8: ns8 + np8 + n_c] = fields[n_s + n_p: n_s + n_p + n_c]
    return geom


def winner_index_plain(counts, o, d, tmin, tmax, geom):
    """Dense grouped winner index i32[R] for planar rays (o, d tuples of
    f32[R]; tmin, tmax f32[R]): :func:`winner_t_index_plain`'s index."""
    return winner_t_index_plain(counts, o, d, tmin, tmax, geom)[1]


def winner_t_index_plain(counts, o, d, tmin, tmax, geom):
    """(best t f32[R], dense grouped winner index i32[R]) for planar rays,
    with `_winner_kernel`'s formulas: each group is an [objects, rays]
    block reduced by argmin (first minimum), and a group's winner replaces
    the best only when strictly closer, so the lowest grouped index wins
    ties.  Where nothing is hit the t is INF and the index 0."""
    n_s, n_p, n_c = counts
    ns8, np8 = ceil8(n_s), ceil8(n_p)
    ox, oy, oz = (v[None, :] for v in o)
    dx, dy, dz = (v[None, :] for v in d)
    tmin = tmin[None, :]
    tmax = tmax[None, :]
    r = ox.shape[1]
    best_t = torch.full((r,), INF, dtype=torch.float32, device=ox.device)
    best_i = torch.zeros((r,), dtype=torch.int32, device=ox.device)

    def combine(best_t, best_i, t_grp, base):
        t_g = t_grp.amin(dim=0)
        i_g = t_grp.argmin(dim=0).to(torch.int32) + base
        better = t_g < best_t
        return torch.where(better, t_g, best_t), torch.where(better, i_g, best_i)

    def inf_where(v, t):
        return torch.where(v, t, torch.full_like(t, INF))

    if n_s:
        g = geom[0:n_s]
        cx, cy, cz, cc = g[:, 0:1], g[:, 1:2], g[:, 2:3], g[:, 6:7]
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        a = dx * dx + dy * dy + dz * dz
        oc = cx * ox + cy * oy + cz * oz
        dc = cx * dx + cy * dy + cz * dz
        b = od - dc
        c = oo - 2.0 * oc + cc
        disc = b * b - a * c
        has = disc > 0
        sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
        inv_a = 1.0 / torch.where(a == 0.0, torch.ones_like(a), a)
        t_near = (-b - sq) * inv_a
        t_far = (-b + sq) * inv_a
        nv = has & (t_near < tmax) & (t_near > tmin)
        fv = has & (t_far < tmax) & (t_far > tmin)
        t_sph = torch.where(nv, t_near, inf_where(fv, t_far))
        best_t, best_i = combine(best_t, best_i, t_sph, 0)

    dy_safe = torch.where(dy == 0.0, torch.ones_like(dy), dy)
    if n_p:
        y0 = geom[ns8: ns8 + n_p, 4:5]
        crossing = ((oy < y0) & (dy > 0.0)) | ((oy > y0) & (dy < 0.0))
        t = (y0 - oy) / dy_safe
        v = crossing & (t < tmax) & (t > tmin)
        best_t, best_i = combine(best_t, best_i, inf_where(v, t), n_s)

    if n_c:
        g = geom[ns8 + np8: ns8 + np8 + n_c]
        cx, cy, cz = g[:, 0:1], g[:, 1:2], g[:, 2:3]
        radius, height, cc2 = g[:, 3:4], g[:, 5:6], g[:, 7:8]
        y_top = cy + height * 0.5
        y_bot = cy - height * 0.5

        def cap(y_plane):
            crossing = ((oy < y_plane) & (dy > 0.0)) | ((oy > y_plane) & (dy < 0.0))
            t = (y_plane - oy) / dy_safe
            ex = ox + t * dx - cx
            ez = oz + t * dz - cz
            r2 = ex * ex + ez * ez
            v = crossing & (t < tmax) & (t > tmin) & (radius > 0.0) & (r2 < radius * radius)
            return inf_where(v, t)

        t_cap = torch.minimum(cap(y_top), cap(y_bot))
        od2 = ox * dx + oz * dz
        oo2 = ox * ox + oz * oz
        ax = dx * dx + dz * dz
        oc2 = cx * ox + cz * oz
        dc2 = cx * dx + cz * dz
        b2 = od2 - dc2
        cq = oo2 - 2.0 * oc2 + cc2
        disc2 = b2 * b2 - ax * cq
        has2 = disc2 > 0
        sq2 = torch.sqrt(torch.where(has2, disc2, torch.ones_like(disc2)))
        inv_ax = 1.0 / torch.where(ax == 0.0, torch.ones_like(ax), ax)
        t_ln = (-b2 - sq2) * inv_ax
        t_lf = (-b2 + sq2) * inv_ax

        def lat_ok(t):
            hy = oy + t * dy
            return has2 & (t < tmax) & (t > tmin) & (hy > y_bot) & (hy < y_top)

        t_lat = torch.minimum(inf_where(lat_ok(t_ln), t_ln), inf_where(lat_ok(t_lf), t_lf))
        best_t, best_i = combine(best_t, best_i, torch.minimum(t_cap, t_lat), n_s + n_p)
    return best_t, best_i
