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
# stages the geometry rows there, WINNER_TILE_ROWS of them at a time.
WINNER_SMEM_MAX = 232448
WINNER_TILE_ROWS = WINNER_SMEM_MAX // 32


def ceil8(n: int) -> int:
    return -(-n // 8) * 8


def winner_index(counts, o, d, tmin, tmax, geom, *, tile_rows=WINNER_TILE_ROWS):
    """Dense grouped winner index i32[R] for planar rays (o, d tuples of
    f32[R]; tmin, tmax f32[R]) over `geom` (:func:`build_geom_rows`);
    0 where nothing is hit.

    CUDA tensors launch ``csrc/winner.cu``; CPU tensors take
    :func:`winner_index_plain`.  Both search the rows in tiles of
    `tile_rows` (a multiple of 8, at most WINNER_TILE_ROWS: one block's
    shared memory on the card), so a scene of any size is searched."""
    dev = tmin.device
    if not (8 <= tile_rows <= WINNER_TILE_ROWS and tile_rows % 8 == 0):
        raise ValueError(f"tile_rows {tile_rows} is not a multiple of 8 in [8, "
                         f"{WINNER_TILE_ROWS}]")
    if dev.type == "cpu":
        return winner_t_index_plain(counts, o, d, tmin, tmax, geom, tile_rows)[1]
    if dev.type != "cuda":
        raise ValueError(f"winner_index runs on cuda or cpu tensors, got {dev}")
    r = tmin.shape[0]
    n_rep = geom.shape[0]
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
            r, n_s, n_p, n_c, n_rep, tile_rows, kb.stream_handle(tmin),
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


def winner_t_index_plain(counts, o, d, tmin, tmax, geom, tile_rows=WINNER_TILE_ROWS):
    """(best t f32[R], dense grouped winner index i32[R]) for planar rays,
    with `_winner_kernel`'s formulas: each group is an [objects, rays]
    block reduced by argmin (first minimum), and a group's winner replaces
    the best only when strictly closer, so the lowest grouped index wins
    ties.  Where nothing is hit the t is INF and the index 0.

    The rows are searched in tiles of `tile_rows` (a multiple of 8), as
    ``csrc/winner.cu`` stages them: rows [r0, r1) of the grouped layout
    are again a grouped scene, and a tile's winner replaces the best only
    when strictly closer, which gives the one-tile search's bits."""
    n_rep = geom.shape[0]
    if n_rep <= tile_rows:
        return _search_rows(counts, o, d, tmin, tmax, geom)
    if tile_rows < 8 or tile_rows % 8:
        raise ValueError(f"tile_rows {tile_rows} is not a positive multiple of 8")
    n_s, n_p, n_c = counts
    p_row = ceil8(n_s)
    c_row = p_row + ceil8(n_p)
    part = lambda lo, hi, base, n: (min(max(lo - base, 0), n), min(max(hi - base, 0), n))
    r = tmin.shape[0]
    best_t = torch.full((r,), INF, dtype=torch.float32, device=tmin.device)
    best_i = torch.zeros((r,), dtype=torch.int32, device=tmin.device)
    for r0 in range(0, n_rep, tile_rows):
        r1 = min(r0 + tile_rows, n_rep)
        (s_lo, s_hi), (p_lo, p_hi), (c_lo, c_hi) = (
            part(r0, r1, 0, n_s), part(r0, r1, p_row, n_p), part(r0, r1, c_row, n_c))
        ns, np_, nc = s_hi - s_lo, p_hi - p_lo, c_hi - c_lo
        t, w = _search_rows((ns, np_, nc), o, d, tmin, tmax, geom[r0:r1])
        w = torch.where(w < ns, w + s_lo,
                        torch.where(w < ns + np_, w - ns + n_s + p_lo,
                                    w - ns - np_ + n_s + n_p + c_lo))
        better = t < best_t
        best_t, best_i = torch.where(better, t, best_t), torch.where(better, w, best_i)
    return best_t, best_i


def _search_rows(counts, o, d, tmin, tmax, geom):
    """:func:`winner_t_index_plain` over all of `geom`'s rows at once."""
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
