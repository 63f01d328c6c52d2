"""Dense ray-primitive intersection, row-major (counterpart of
``cpppathtracer_tpu/ops/intersect.py``).

Every ray of a batch is tested against every object as dense [..., N]
tensor operations, the closest hit is an argmin over the object axis (the
first index wins a tie, as in the JAX package), and the winner's t and
normal are computed again from the gathered object, with gradients.  Each
sub-candidate (sphere near/far root, cylinder caps and lateral near/far)
is tested against the ray's own (tmin, tmax) window, and the smallest
valid t wins, which equals the reference's loop that shrinks tmax
(`cuSrc/object.cu:10-128`, `cuSrc/bvh.cu:167-205`).

Conventions of the reference (`object.cu`): the sphere's near-root normal
is (p - c) / radius, so a negative radius inverts it (:22-23); the far
root's is normalize(p - c) (:30); the platform's (0, -sign(dir.y), 0)
(:43); a cylinder cap's the same flat normal, its lateral surface's
radial in xz (:62, :97), and a cap wins an exact tie with the lateral
surface.

Every square root and division is guarded by a second select (the
"double where"): a lane whose value is thrown away evaluates it at a
dummy, so no infinite slope meets a zero cotangent in the backward.
"""

from __future__ import annotations

import torch

from cpppathtracer_tpu_torch.ops import mathx
from cpppathtracer_tpu_torch.types import INF, Hit, PrimitiveType


def _inf_where(valid, t):
    return torch.where(valid, t, torch.full_like(t, INF))


def _sphere_candidates(o, d, center, radius, tmin, tmax):
    """Near and far roots (`object.cu:10-35`).  o, d, center f32[..., 3]
    and radius, tmin, tmax f32[...] broadcast.  Returns (t_near,
    near_valid, t_far, far_valid)."""
    acx, acy, acz = o[..., 0] - center[..., 0], o[..., 1] - center[..., 1], o[..., 2] - center[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy + dz * dz
    b = acx * dx + acy * dy + acz * dz
    c = acx * acx + acy * acy + acz * acz - radius * radius
    disc = b * b - a * c
    has = disc > 0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t_near = mathx.safe_div(-b - sq, a)
    t_far = mathx.safe_div(-b + sq, a)
    near_valid = has & (t_near < tmax) & (t_near > tmin)
    far_valid = has & (t_far < tmax) & (t_far > tmin)
    return t_near, near_valid, t_far, far_valid


def _platform_candidate(o, d, y_pos, tmin, tmax):
    """The infinite y-plane (`object.cu:37-48`): (t, valid)."""
    oy, dy = o[..., 1], d[..., 1]
    crossing = ((oy < y_pos) & (dy > 0.0)) | ((oy > y_pos) & (dy < 0.0))
    t = mathx.safe_div(y_pos - oy, dy)
    return t, crossing & (t < tmax) & (t > tmin)


def _cylinder_candidates(o, d, center, radius, height, tmin, tmax):
    """Caps and lateral surface (`object.cu:50-112`): ((t, valid) x 4) for
    the top cap, the bottom cap, the lateral near and far roots."""
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    y_top = cy + height / 2
    y_bot = cy - height / 2

    def cap(y_plane):
        crossing = ((oy < y_plane) & (dy > 0.0)) | ((oy > y_plane) & (dy < 0.0))
        t = mathx.safe_div(y_plane - oy, dy)
        ex = ox + t * dx - cx
        ez = oz + t * dz - cz
        r2 = ex * ex + ez * ez
        # the reference compares sqrt(r2) < radius, never true for a
        # negative radius
        in_disc = (radius > 0.0) & (r2 < radius * radius)
        return t, crossing & (t < tmax) & (t > tmin) & in_disc

    t_top, v_top = cap(y_top)
    t_bot, v_bot = cap(y_bot)

    ax = dx * dx + dz * dz
    rx = ox - cx
    rz = oz - cz
    b = rx * dx + rz * dz
    c = rx * rx + rz * rz - radius * radius
    disc = b * b - ax * c
    has = disc > 0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t_ln = mathx.safe_div(-b - sq, ax)
    t_lf = mathx.safe_div(-b + sq, ax)

    def lateral_valid(t):
        hy = oy + t * dy
        return has & (t < tmax) & (t > tmin) & (hy > y_bot) & (hy < y_top)

    return ((t_top, v_top), (t_bot, v_bot), (t_ln, lateral_valid(t_ln)),
            (t_lf, lateral_valid(t_lf)))


def _object_best_t(prim_type, center, radius, y_pos, height, o, d, tmin, tmax):
    """The best candidate t of each (ray, object) pair, INF where none:
    the object fields broadcast against the rays (o, d f32[..., 3])."""
    t_sn, v_sn, t_sf, v_sf = _sphere_candidates(o, d, center, radius, tmin, tmax)
    # the near root if valid, else the far root (object.cu:18-32)
    t_sph = torch.where(v_sn, t_sn, _inf_where(v_sf, t_sf))
    t_pl, v_pl = _platform_candidate(o, d, y_pos, tmin, tmax)
    (t_ct, v_ct), (t_cb, v_cb), (t_ln, v_ln), (t_lf, v_lf) = _cylinder_candidates(
        o, d, center, radius, height, tmin, tmax
    )
    t_cyl = torch.minimum(
        torch.minimum(_inf_where(v_ct, t_ct), _inf_where(v_cb, t_cb)),
        torch.minimum(_inf_where(v_ln, t_ln), _inf_where(v_lf, t_lf)),
    )
    return torch.where(
        prim_type == PrimitiveType.SPHERE,
        t_sph,
        torch.where(
            prim_type == PrimitiveType.PLATFORM,
            _inf_where(v_pl, t_pl),
            _inf_where(prim_type == PrimitiveType.CYLINDER, t_cyl),
        ),
    )


def _object_hit_attrs(prim_type, center, radius, y_pos, height, o, d, tmin, tmax):
    """(t, normal) of each ray against its own object (every field
    gathered per ray, f32[R] / f32[R, 3]).  The attributes are evaluated
    at t = 0 on a miss, so no INF reaches the backward through a select."""
    t_sn, v_sn, t_sf, v_sf = _sphere_candidates(o, d, center, radius, tmin, tmax)
    t_sph = torch.where(v_sn, t_sn, _inf_where(v_sf, t_sf))
    zero = torch.zeros_like(t_sph)
    t_sph_safe = torch.where(t_sph < INF, t_sph, zero)
    p_sph = o + t_sph_safe[..., None] * d
    safe_r = torch.where(radius == 0, torch.ones_like(radius), radius)
    n_near = (p_sph - center) / safe_r[..., None]
    n_far = mathx.normalize(p_sph - center)
    n_sph = torch.where(v_sn[..., None], n_near, n_far)

    t_pl, v_pl = _platform_candidate(o, d, y_pos, tmin, tmax)
    t_plat = _inf_where(v_pl, t_pl)
    dy = d[..., 1]
    n_plat = torch.stack([torch.zeros_like(dy), -torch.sign(dy), torch.zeros_like(dy)], dim=-1)

    (t_ct, v_ct), (t_cb, v_cb), (t_ln, v_ln), (t_lf, v_lf) = _cylinder_candidates(
        o, d, center, radius, height, tmin, tmax
    )
    t_cap = torch.minimum(_inf_where(v_ct, t_ct), _inf_where(v_cb, t_cb))
    t_lat = torch.minimum(_inf_where(v_ln, t_ln), _inf_where(v_lf, t_lf))
    t_cyl = torch.minimum(t_cap, t_lat)
    # the caps are tested before the lateral surface (object.cu:50-112):
    # on an exact tie the cap's flat normal wins
    is_cap = (t_cyl == t_cap) & (t_cap < INF)
    t_cyl_safe = torch.where(t_cyl < INF, t_cyl, zero)
    p_cyl = o + t_cyl_safe[..., None] * d
    radial = torch.stack(
        [p_cyl[..., 0] - center[..., 0], torch.zeros_like(dy), p_cyl[..., 2] - center[..., 2]],
        dim=-1,
    )
    n_cyl = torch.where(is_cap[..., None], n_plat, mathx.normalize(radial))

    is_sphere = prim_type == PrimitiveType.SPHERE
    is_plat = prim_type == PrimitiveType.PLATFORM
    is_cyl = prim_type == PrimitiveType.CYLINDER
    t = torch.where(is_sphere, t_sph,
                    torch.where(is_plat, t_plat, _inf_where(is_cyl, t_cyl)))
    n = torch.where(is_sphere[..., None], n_sph,
                    torch.where(is_plat[..., None], n_plat, n_cyl))
    return t, n


def take_rows(a, idx):
    """Rows idx (i64[...]) of a (leading dim N): index_select, whose
    backward adds the cotangents into the rows (see
    ``planar.gather_epilogue_p``)."""
    return a.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *a.shape[1:])


def winner_attrs(scene, rays, obj_idx):
    """(t, normal) of each ray of `rays` against the object obj_idx
    (i64[...], clamped to >= 0), computed again from the gathered object
    with gradients to the rays and the scene's geometry."""
    take = lambda a: take_rows(a, torch.clamp(obj_idx, min=0))
    return _object_hit_attrs(
        take(scene.prim_type), take(scene.center), take(scene.radius), take(scene.y_pos),
        take(scene.height), rays.origin, rays.dir, rays.tmin, rays.tmax,
    )


def intersect(scene, rays) -> Hit:
    """Closest hit of each ray of `rays` (any batch shape) against the
    whole scene.  Two passes: the dense [..., N] candidate t's and their
    argmin, which only selects and so runs without a graph, then the
    winner's attributes computed again per ray, with gradients.  As in
    the JAX package, pos = origin + t dir and the normal are left as they
    come on a miss (t = INF there)."""
    with torch.no_grad():
        t_all = _object_best_t(
            scene.prim_type, scene.center, scene.radius, scene.y_pos, scene.height,
            rays.origin[..., None, :], rays.dir[..., None, :],
            rays.tmin[..., None], rays.tmax[..., None],
        )
        obj_idx = torch.argmin(t_all, dim=-1)
    t, normal = winner_attrs(scene, rays, obj_idx)
    hit = t < INF
    return Hit(
        t=t,
        hit=hit,
        pos=rays.origin + t[..., None] * rays.dir,
        normal=normal,
        obj_idx=torch.where(hit, obj_idx, torch.full_like(obj_idx, -1)).to(torch.int32),
    )
