"""Planar (structure-of-planes) bounce body: every 3-vector is a tuple of
three flat float32[R] tensors.

Counterpart of ``cpppathtracer_tpu/ops/planar.py``, scalar op for scalar
op in the same order, so that the plain PyTorch path and the CUDA kernels
(``csrc/mega_trace.cu`` repeats this arithmetic) agree with the JAX package
to float32 rounding.  Reference semantics: `cuSrc/object.cu:10-112`
(primitives), `cuSrc/material.cu:20-163` (BSDFs),
`include/ray_tracing_math.hpp:43-80` (math helpers).
"""

from __future__ import annotations

import math

import torch

from cpppathtracer_tpu_torch.ops.mathx import EPS, safe_div, schlick
from cpppathtracer_tpu_torch.types import INF, MaterialType, PrimitiveType

_TWO_PI = 2.0 * math.pi


def v3(x, y, z):
    return (x, y, z)


def stack_v3(p):
    return torch.stack(p, dim=-1)


def unstack_v3(a):
    return (a[..., 0], a[..., 1], a[..., 2])


def dot_p(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def scale_p(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def add_p(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub_p(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul_p(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def where_p(c, a, b):
    return tuple(torch.where(c, a[i], b[i]) for i in range(3))


def cross_p(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _zero(x):
    return torch.zeros_like(x)


def normalize_p(v):
    """Zero-guarded normalize (rsqrt of the squared length; 0 for a zero
    vector)."""
    n2 = dot_p(v, v)
    inv = torch.where(n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=EPS)), _zero(n2))
    return scale_p(v, inv)


def reflect_p(i, n):
    s = 2.0 * dot_p(i, n)
    return (i[0] - s * n[0], i[1] - s * n[1], i[2] - s * n[2])


def to_world_p(ax, ay, az, n):
    """Local (z-up) direction into the frame around n
    (`ray_tracing_math.hpp:51-63`)."""
    nx, ny, nz = n
    use_x = torch.abs(nx) > torch.abs(ny)
    inv_len_x = 1.0 / torch.sqrt(torch.clamp(nx * nx + nz * nz, min=EPS))
    inv_len_y = 1.0 / torch.sqrt(torch.clamp(ny * ny + nz * nz, min=EPS))
    zero = _zero(nx)
    c = (
        torch.where(use_x, nz * inv_len_x, zero),
        torch.where(use_x, zero, nz * inv_len_y),
        torch.where(use_x, -nx * inv_len_x, -ny * inv_len_y),
    )
    b = cross_p(c, n)
    return (
        ax * b[0] + ay * c[0] + az * n[0],
        ax * b[1] + ay * c[1] + az * n[1],
        ax * b[2] + ay * c[2] + az * n[2],
    )


def refract_p(v, n, ni_over_nt):
    """Snell refraction (`ray_tracing_math.hpp:71-80`): (dir, ok); the
    direction is zero where total internal reflection occurs."""
    uv = normalize_p(v)
    dt = dot_p(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    refr = normalize_p(
        (
            ni_over_nt * (uv[0] - n[0] * dt) - n[0] * sq,
            ni_over_nt * (uv[1] - n[1] * dt) - n[1] * sq,
            ni_over_nt * (uv[2] - n[2] * dt) - n[2] * sq,
        )
    )
    zero = _zero(dt)
    return where_p(ok, refr, (zero, zero, zero)), ok


def phong_lobe_p(u1, u2, alpha):
    """The reference's Phong-style lobe in local coordinates
    (`material.cu:23-26`), with r^2 = -expm1(y) spelled
    -tanh(y/2) * (e^y + 1) as the JAX package does."""
    log_u = torch.log(torch.clamp(u1, min=1e-38))
    inv_a = 1.0 / alpha
    z = torch.exp(log_u * inv_a)
    y = 2.0 * log_u * inv_a
    r = torch.sqrt(torch.clamp(-torch.tanh(0.5 * y) * (torch.exp(y) + 1.0), min=0.0))
    phi = _TWO_PI * u2
    return r * torch.cos(phi), r * torch.sin(phi), z


def shade_p(mat, normal, in_dir, u1, u2, u3):
    """BSDF sampling, forward only (the JAX `shade_p` with
    score_grad=False, as its megakernel calls it).

    mat: dict of float32[R] tensors mat_type (int), smoothness,
    reflectivity, ior, emission, and kd_p, a planar vec3.
    Returns (bounce_dir, attenuation, emitted), planar vec3s.
    """
    mat_type = mat["mat_type"]
    kd = mat["kd_p"]
    smoothness = mat["smoothness"]
    reflectivity = mat["reflectivity"]
    ior = mat["ior"]

    is_metal = mat_type == MaterialType.METAL
    is_mirror = mat_type == MaterialType.MIRROR
    is_glass = mat_type == MaterialType.GLASS
    is_diffuse = ~(is_metal | is_mirror | is_glass)

    alpha_phong = torch.pow(torch.full_like(smoothness, 1000.0), smoothness)
    reflect_dir = reflect_p(in_dir, normal)
    mirror_reflects = u3 < reflectivity

    d_dot_n = dot_p(in_dir, normal)
    inside = d_dot_n > 0
    outward_n = where_p(inside, scale_p(normal, -1.0), normal)
    ni_over_nt = torch.where(
        inside, ior, 1.0 / torch.where(ior == 0, torch.ones_like(ior), ior)
    )
    cos_arg = 1.0 - ior * ior * (1.0 - d_dot_n * d_dot_n)
    pos_arg = cos_arg > 0
    cos_in = torch.sqrt(torch.where(pos_arg, cos_arg, torch.ones_like(cos_arg)))
    cos_in = torch.where(pos_arg, cos_in, _zero(cos_in))
    cosine = torch.where(inside, cos_in, -d_dot_n)
    refracted, refract_ok = refract_p(in_dir, outward_n, ni_over_nt)
    reflect_prob = torch.where(
        refract_ok, schlick(cosine, ior), torch.ones_like(cosine)
    )
    glass_reflects = u3 < reflect_prob

    two = torch.full_like(alpha_phong, 2.0)
    alpha = torch.where(
        is_diffuse, two, torch.where(is_mirror & ~mirror_reflects, two, alpha_phong)
    )
    base = where_p(
        is_diffuse,
        normal,
        where_p(
            is_mirror,
            where_p(mirror_reflects, reflect_dir, normal),
            where_p(
                is_glass,
                where_p(glass_reflects, reflect_dir, refracted),
                reflect_dir,  # METAL
            ),
        ),
    )

    lx, ly, lz = phong_lobe_p(u1, u2, alpha)
    bounce_dir = to_world_p(lx, ly, lz, base)

    above_horizon = dot_p(normal, bounce_dir) > 0
    atten_on = is_glass | above_horizon
    zero = _zero(u1)
    attenuation = where_p(atten_on, kd, (zero, zero, zero))
    emitted = scale_p(kd, mat["emission"])
    return bounce_dir, attenuation, emitted


def object_hit_attrs_p(prim_type, center, radius, y_pos, height, o, d, tmin, tmax):
    """(t, normal) of each ray against its winner object, given the
    winner's fields as float32[R] tensors (center, o, d planar vec3)."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz = center
    inf = torch.full_like(ox, INF)
    zero = _zero(dy)
    one = torch.ones_like(dy)

    # sphere (object.cu:10-35)
    acx, acy, acz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = acx * dx + acy * dy + acz * dz
    c = acx * acx + acy * acy + acz * acz - radius * radius
    disc = b * b - a * c
    has = disc > 0
    sq = torch.sqrt(torch.where(has, disc, one))
    t_sn = safe_div(-b - sq, a)
    t_sf = safe_div(-b + sq, a)
    v_sn = has & (t_sn < tmax) & (t_sn > tmin)
    v_sf = has & (t_sf < tmax) & (t_sf > tmin)
    t_sph = torch.where(v_sn, t_sn, torch.where(v_sf, t_sf, inf))
    t_sph_safe = torch.where(t_sph < INF, t_sph, zero)
    p_sph = (ox + t_sph_safe * dx, oy + t_sph_safe * dy, oz + t_sph_safe * dz)
    pc = sub_p(p_sph, center)
    inv_r = 1.0 / torch.where(radius == 0, torch.ones_like(radius), radius)
    n_sph = where_p(v_sn, scale_p(pc, inv_r), normalize_p(pc))

    # platform (object.cu:37-48)
    crossing = ((oy < y_pos) & (dy > 0.0)) | ((oy > y_pos) & (dy < 0.0))
    t_pl = safe_div(y_pos - oy, dy)
    v_pl = crossing & (t_pl < tmax) & (t_pl > tmin)
    t_plat = torch.where(v_pl, t_pl, inf)
    n_plat = (zero, -torch.sign(dy), zero)

    # cylinder (object.cu:50-112)
    y_top = cy + height / 2
    y_bot = cy - height / 2

    def cap(y_plane):
        cross = ((oy < y_plane) & (dy > 0.0)) | ((oy > y_plane) & (dy < 0.0))
        t = safe_div(y_plane - oy, dy)
        ex = ox + t * dx - cx
        ez = oz + t * dz - cz
        r2 = ex * ex + ez * ez
        in_disc = (radius > 0.0) & (r2 < radius * radius)
        return t, cross & (t < tmax) & (t > tmin) & in_disc

    t_ct, v_ct = cap(y_top)
    t_cb, v_cb = cap(y_bot)
    axc = dx * dx + dz * dz
    rx = ox - cx
    rz = oz - cz
    bc = rx * dx + rz * dz
    cc = rx * rx + rz * rz - radius * radius
    disc_c = bc * bc - axc * cc
    has_c = disc_c > 0
    sq_c = torch.sqrt(torch.where(has_c, disc_c, one))
    t_ln = safe_div(-bc - sq_c, axc)
    t_lf = safe_div(-bc + sq_c, axc)

    def lat_ok(t):
        hy = oy + t * dy
        return has_c & (t < tmax) & (t > tmin) & (hy > y_bot) & (hy < y_top)

    t_cap = torch.minimum(torch.where(v_ct, t_ct, inf), torch.where(v_cb, t_cb, inf))
    t_lat = torch.minimum(
        torch.where(lat_ok(t_ln), t_ln, inf), torch.where(lat_ok(t_lf), t_lf, inf)
    )
    t_cyl = torch.minimum(t_cap, t_lat)
    is_cap = (t_cyl == t_cap) & (t_cap < INF)
    t_cyl_safe = torch.where(t_cyl < INF, t_cyl, zero)
    radial = (ox + t_cyl_safe * dx - cx, zero, oz + t_cyl_safe * dz - cz)
    n_cyl = where_p(is_cap, n_plat, normalize_p(radial))

    is_sphere = prim_type == PrimitiveType.SPHERE
    is_plat = prim_type == PrimitiveType.PLATFORM
    is_cyl = prim_type == PrimitiveType.CYLINDER
    t = torch.where(
        is_sphere, t_sph, torch.where(is_plat, t_plat, torch.where(is_cyl, t_cyl, inf))
    )
    n = where_p(is_sphere, n_sph, where_p(is_plat, n_plat, n_cyl))
    return t, n


def gather_epilogue_p(table_s, table_r, o, d, tmin, tmax, gidx):
    """Winner record fetch (an index gather, never a matmul) plus hit
    attributes.  table_s f32[N, 13], table_r f32[N, 4] in the
    ``ops/fast.py`` column layout; gidx i32[R] dense grouped indices.
    Returns (hitrec, mats) dicts of planar tensors."""
    idx = gidx.long()
    rec = table_s[idx].T  # [F_S, R]
    rec_r = table_r[idx].T  # [F_R, R]
    prim_type = rec[6].to(torch.int32)
    center = (rec[0], rec[1], rec[2])
    t, normal = object_hit_attrs_p(
        prim_type, center, rec[3], rec[4], rec[5], o, d, tmin, tmax
    )
    hit = t < INF
    zero = _zero(t)
    t_safe = torch.where(hit, t, zero)
    pos = add_p(o, scale_p(d, t_safe))
    mats = {
        "mat_type": rec[7].to(torch.int32),
        "kd_p": (rec_r[0], rec_r[1], rec_r[2]),
        "emission": rec_r[3],
        "smoothness": rec[8],
        "reflectivity": rec[9],
        "ior": rec[10],
        "tex_id": rec[11].to(torch.int32),
    }
    hitrec = {
        "t": torch.where(hit, t, torch.full_like(t, INF)),
        "hit": hit,
        "pos": pos,
        "normal": where_p(hit, normal, (zero, zero, zero)),
        "obj_idx": torch.where(hit, rec[12].to(torch.int32), torch.full_like(prim_type, -1)),
    }
    return hitrec, mats
