"""The plain reference path tracer: PyTorch tensor operations and nothing of
the program.

It computes what the program's render paths compute: per (pixel, sample)
a camera ray, up to `depth` bounces of closest hit, hit record, PCG4D
uniforms and BSDF sampling, the radiance gathered on live hits, and the sky
seen by the paths that escaped (`cuSrc/path_tracer.cu:141-170`).  Its
arithmetic is a frozen copy of the planar bounce body's formulas (the
reference's `object.cu`, `material.cu`, `ray_tracing_math.hpp`), written
again here so that the yardstick does not move with the program.  What is
its own: the closest hit is a dense search over every object of each
primitive type (no BVH, no kernel), the sky is the plain four-tap bilinear
fetch with mirror addressing, only live paths are traced, and the radiance
of a path can be kept as a record (the objects hit, whether each bounce
attenuates, the sky seen) so that a loss over kd and emission can be
differentiated by a small recurrence: a path's geometry does not depend on
either.

The search takes one of two forms of the same tests, as the configuration
states (`search`): `direct` (sphere b = (o - c).d, the form of the BVH
walk's leaf tests and of every hit's recomputation) or `expanded` (b =
o.d - c.d, c = o.o - 2 o.c + |c|^2 - r^2, the form of the dense winner
search).  At the scenes' coordinates (up to about a thousand) float32
rounds the two differently where a bounce ray grazes the surface it
leaves, so whether it hits that surface again at t just above tmin differs
between them, and a path that differs there differs after it.  The winner's
hit is then recomputed in the direct form, and a winner whose recomputed t
fails its window is a miss, as on every path of the program.

Every floating-point tensor is in `dtype`: float32 is the reference; a lower
precision (bfloat16) is the control that the comparison must reject.
Sums over samples, losses and gradients are taken in float64 for float32
(in `dtype` itself for the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

INF = float(np.float32(1e30))
TMIN_BOUNCE = float(np.float32(2e-5))
EPS = 1e-12
SEARCH_ELEMENTS = 1 << 25  # rays x objects of one block of the dense search


def acc_dtype(dtype):
    return torch.float64 if dtype == torch.float32 else dtype


# ---- PCG4D uniforms, a pure function of (seed, pixel, sample, counter)


def u32_word(v: int) -> int:
    """A Python int's uint32 bit pattern as a signed 32-bit int."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _pcg4d(x, y, z, w):
    """PCG4D on int32 tensors, whose products and sums wrap modulo 2^32 as
    uint32 ones do; logical right shifts are masked arithmetic ones."""
    mul, add = 1664525, 1013904223
    x, y, z, w = x * mul + add, y * mul + add, z * mul + add, w * mul + add
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ ((x >> 16) & 0xFFFF)
    y = y ^ ((y >> 16) & 0xFFFF)
    z = z ^ ((z >> 16) & 0xFFFF)
    w = w ^ ((w >> 16) & 0xFFFF)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def uniforms(seed: int, pix, samp, ctr: int, dtype):
    """Four U[0, 1) tensors for int32 pixel and sample keys."""
    full = lambda v: torch.full_like(pix, u32_word(v))
    outs = _pcg4d(pix, samp, full(ctr), full(seed))
    return tuple(((v >> 8) & 0xFFFFFF).to(dtype) * (2.0 ** -24) for v in outs)


# ---- planar 3-vectors: tuples of three tensors


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def where3(c, a, b):
    return tuple(torch.where(c, a[i], b[i]) for i in range(3))


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def normalize(v):
    n2 = dot(v, v)
    inv = torch.where(n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=EPS)), torch.zeros_like(n2))
    return scale(v, inv)


def safe_div(num, den):
    return num / torch.where(den == 0.0, torch.ones_like(den), den)


def div_exact(x, c: float):
    """x / c as an IEEE division (never a multiplication by 1/c)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# ---- scene


class Scene:
    """A scene's arrays on `device` in `dtype`, and each primitive type's
    objects (their indices in the scene's order) for the dense search."""

    def __init__(self, arrays: dict, device, dtype, search: str = "direct"):
        if search not in ("direct", "expanded"):
            raise ValueError(f"search form {search!r}")
        self.search = search
        self.dtype, self.device = dtype, torch.device(device)
        f = lambda k: torch.as_tensor(np.asarray(arrays[k]), device=device).to(dtype)
        i = lambda k: torch.as_tensor(np.asarray(arrays[k]), device=device).to(torch.int32)
        self.prim_type, self.mat_type = i("prim_type"), i("mat_type")
        c = f("center")
        self.center = (c[:, 0].contiguous(), c[:, 1].contiguous(), c[:, 2].contiguous())
        self.radius, self.y_pos, self.height = f("radius"), f("y_pos"), f("height")
        self.kd, self.emission = f("kd"), f("emission")
        self.smoothness, self.reflectivity, self.ior = f("smoothness"), f("reflectivity"), f("ior")
        self.n = int(self.prim_type.shape[0])
        pt = np.asarray(arrays["prim_type"])
        self.groups = {t: torch.as_tensor(np.where(pt == t)[0], device=device) for t in (0, 1, 2)}

    def fields(self, idx):
        """The geometry of objects idx (int64), gathered."""
        g = lambda a: a.index_select(0, idx)
        return (g(self.prim_type), tuple(g(c) for c in self.center), g(self.radius),
                g(self.y_pos), g(self.height))


# ---- primitive tests (object.cu:10-112): (t, normal) and the best t


def _sphere(o, d, center, radius, tmin, tmax):
    acx, acy, acz = o[0] - center[0], o[1] - center[1], o[2] - center[2]
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    b = acx * d[0] + acy * d[1] + acz * d[2]
    c = acx * acx + acy * acy + acz * acz - radius * radius
    disc = b * b - a * c
    has = disc > 0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t_n = safe_div(-b - sq, a)
    t_f = safe_div(-b + sq, a)
    v_n = has & (t_n < tmax) & (t_n > tmin)
    v_f = has & (t_f < tmax) & (t_f > tmin)
    return torch.where(v_n, t_n, torch.where(v_f, t_f, torch.full_like(t_f, INF))), v_n


def _plane_t(o, d, y_plane, tmin, tmax):
    oy, dy = o[1], d[1]
    crossing = ((oy < y_plane) & (dy > 0.0)) | ((oy > y_plane) & (dy < 0.0))
    t = safe_div(y_plane - oy, dy)
    return t, crossing & (t < tmax) & (t > tmin)


def _platform(o, d, y_pos, tmin, tmax):
    t, v = _plane_t(o, d, y_pos, tmin, tmax)
    return torch.where(v, t, torch.full_like(t, INF))


def _cylinder(o, d, center, radius, height, tmin, tmax):
    """(t, t of the caps): a cap wins an exact tie with the lateral
    surface."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz = center
    y_top = cy + height / 2
    y_bot = cy - height / 2

    def cap(y_plane):
        t, v = _plane_t(o, d, y_plane, tmin, tmax)
        ex = ox + t * dx - cx
        ez = oz + t * dz - cz
        r2 = ex * ex + ez * ez
        return torch.where(v & (radius > 0.0) & (r2 < radius * radius), t,
                           torch.full_like(t, INF))

    t_cap = torch.minimum(cap(y_top), cap(y_bot))
    ax = dx * dx + dz * dz
    rx = ox - cx
    rz = oz - cz
    b = rx * dx + rz * dz
    c = rx * rx + rz * rz - radius * radius
    disc = b * b - ax * c
    has = disc > 0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))

    def lateral(t):
        hy = oy + t * dy
        ok = has & (t < tmax) & (t > tmin) & (hy > y_bot) & (hy < y_top)
        return torch.where(ok, t, torch.full_like(t, INF))

    t_lat = torch.minimum(lateral(safe_div(-b - sq, ax)), lateral(safe_div(-b + sq, ax)))
    return torch.minimum(t_cap, t_lat), t_cap


def _sphere_expanded(o, d, center, radius, cc, tmin, tmax):
    """The sphere test in expanded form: b = o.d - c.d, c = o.o - 2 o.c +
    (|c|^2 - r^2)."""
    ox, oy, oz = o
    dx, dy, dz = d
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    a = dx * dx + dy * dy + dz * dz
    oc = center[0] * ox + center[1] * oy + center[2] * oz
    dc = center[0] * dx + center[1] * dy + center[2] * dz
    b = od - dc
    c = oo - 2.0 * oc + cc
    disc = b * b - a * c
    has = disc > 0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    inv_a = 1.0 / torch.where(a == 0.0, torch.ones_like(a), a)
    t_n = (-b - sq) * inv_a
    t_f = (-b + sq) * inv_a
    v_n = has & (t_n < tmax) & (t_n > tmin)
    v_f = has & (t_f < tmax) & (t_f > tmin)
    return torch.where(v_n, t_n, torch.where(v_f, t_f, torch.full_like(t_f, INF)))


def _cylinder_expanded(o, d, center, radius, height, cc2, tmin, tmax):
    """The cylinder test with its lateral surface in expanded form."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz = center
    y_top = cy + height * 0.5
    y_bot = cy - height * 0.5
    dy_safe = torch.where(dy == 0.0, torch.ones_like(dy), dy)

    def cap(y_plane):
        crossing = ((oy < y_plane) & (dy > 0.0)) | ((oy > y_plane) & (dy < 0.0))
        t = (y_plane - oy) / dy_safe
        ex = ox + t * dx - cx
        ez = oz + t * dz - cz
        r2 = ex * ex + ez * ez
        ok = crossing & (t < tmax) & (t > tmin) & (radius > 0.0) & (r2 < radius * radius)
        return torch.where(ok, t, torch.full_like(t, INF))

    t_cap = torch.minimum(cap(y_top), cap(y_bot))
    b = (ox * dx + oz * dz) - (cx * dx + cz * dz)
    c = (ox * ox + oz * oz) - 2.0 * (cx * ox + cz * oz) + cc2
    ax = dx * dx + dz * dz
    disc = b * b - ax * c
    has = disc > 0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    inv_ax = 1.0 / torch.where(ax == 0.0, torch.ones_like(ax), ax)

    def lateral(t):
        hy = oy + t * dy
        ok = has & (t < tmax) & (t > tmin) & (hy > y_bot) & (hy < y_top)
        return torch.where(ok, t, torch.full_like(t, INF))

    return torch.minimum(t_cap, torch.minimum(lateral((-b - sq) * inv_ax),
                                              lateral((-b + sq) * inv_ax)))


def _best_in_group(scene: Scene, kind: int, o, d, tmin):
    """(t, object index) of each ray's nearest object of one primitive type,
    by a dense search in blocks of rays; (INF, -1) where none is hit."""
    objs = scene.groups[kind]
    r = o[0].shape[0]
    best_t = torch.full((r,), INF, dtype=scene.dtype, device=scene.device)
    best_i = torch.full((r,), -1, dtype=torch.int64, device=scene.device)
    if objs.numel() == 0 or r == 0:
        return best_t, best_i
    col = lambda a: a.index_select(0, objs)[None, :]
    center = tuple(col(c) for c in scene.center)
    radius, y_pos, height = col(scene.radius), col(scene.y_pos), col(scene.height)
    r2 = radius * radius
    cc = center[0] * center[0] + center[1] * center[1] + center[2] * center[2] - r2
    cc2 = center[0] * center[0] + center[2] * center[2] - r2
    expanded = scene.search == "expanded"
    block = max(1, SEARCH_ELEMENTS // objs.numel())
    for lo in range(0, r, block):
        hi = min(r, lo + block)
        ob = tuple(c[lo:hi, None] for c in o)
        db = tuple(c[lo:hi, None] for c in d)
        tb = tmin[lo:hi, None]
        if kind == 0:
            t = (_sphere_expanded(ob, db, center, radius, cc, tb, INF) if expanded
                 else _sphere(ob, db, center, radius, tb, INF)[0])
        elif kind == 1:
            t = _platform(ob, db, y_pos, tb, INF)
        else:
            t = (_cylinder_expanded(ob, db, center, radius, height, cc2, tb, INF) if expanded
                 else _cylinder(ob, db, center, radius, height, tb, INF)[0])
        tmin_b, arg = t.min(dim=1)
        hit = tmin_b < INF
        best_t[lo:hi] = tmin_b
        best_i[lo:hi] = torch.where(hit, objs[arg], torch.full_like(arg, -1))
    return best_t, best_i


def closest(scene: Scene, o, d, tmin):
    """Each ray's closest object (int64 scene index, -1 on a miss): spheres,
    then platforms, then cylinders; an earlier group wins an exact tie."""
    best_t, best_i = _best_in_group(scene, 0, o, d, tmin)
    for kind in (1, 2):
        t, i = _best_in_group(scene, kind, o, d, tmin)
        nearer = t < best_t
        best_t = torch.where(nearer, t, best_t)
        best_i = torch.where(nearer, i, best_i)
    return best_i


def hit_attrs(scene: Scene, idx, o, d, tmin):
    """(t, normal) of each ray against its object idx (>= 0), computed again
    from the object's fields; t is INF where the test fails."""
    prim, center, radius, y_pos, height = scene.fields(idx)
    zero = torch.zeros_like(o[0])
    t_sph, v_near = _sphere(o, d, center, radius, tmin, INF)
    ts = torch.where(t_sph < INF, t_sph, zero)
    pc = sub((o[0] + ts * d[0], o[1] + ts * d[1], o[2] + ts * d[2]), center)
    inv_r = 1.0 / torch.where(radius == 0, torch.ones_like(radius), radius)
    n_sph = where3(v_near, scale(pc, inv_r), normalize(pc))
    t_pl = _platform(o, d, y_pos, tmin, INF)
    n_flat = (zero, -torch.sign(d[1]), zero)
    t_cyl, t_cap = _cylinder(o, d, center, radius, height, tmin, INF)
    is_cap = (t_cyl == t_cap) & (t_cap < INF)
    tc = torch.where(t_cyl < INF, t_cyl, zero)
    radial = (o[0] + tc * d[0] - center[0], zero, o[2] + tc * d[2] - center[2])
    n_cyl = where3(is_cap, n_flat, normalize(radial))
    sph, pl = prim == 0, prim == 1
    t = torch.where(sph, t_sph, torch.where(pl, t_pl, t_cyl))
    n = where3(sph, n_sph, where3(pl, n_flat, n_cyl))
    return t, n


# ---- BSDF sampling (material.cu:20-163)


def _reflect(i, n):
    s = 2.0 * dot(i, n)
    return (i[0] - s * n[0], i[1] - s * n[1], i[2] - s * n[2])


def _to_world(ax, ay, az, n):
    nx, ny, nz = n
    use_x = torch.abs(nx) > torch.abs(ny)
    inv_x = 1.0 / torch.sqrt(torch.clamp(nx * nx + nz * nz, min=EPS))
    inv_y = 1.0 / torch.sqrt(torch.clamp(ny * ny + nz * nz, min=EPS))
    zero = torch.zeros_like(nx)
    c = (torch.where(use_x, nz * inv_x, zero), torch.where(use_x, zero, nz * inv_y),
         torch.where(use_x, -nx * inv_x, -ny * inv_y))
    b = cross(c, n)
    return tuple(ax * b[k] + ay * c[k] + az * n[k] for k in range(3))


def _refract(v, n, eta):
    uv = normalize(v)
    dt = dot(uv, n)
    disc = 1.0 - eta * eta * (1.0 - dt * dt)
    ok = disc > 0
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    refr = normalize(tuple(eta * (uv[k] - n[k] * dt) - n[k] * sq for k in range(3)))
    zero = torch.zeros_like(dt)
    return where3(ok, refr, (zero, zero, zero)), ok


def _schlick(cosine, ior):
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    m = torch.clamp(1.0 - cosine, min=0.0)
    return r0 + (1.0 - r0) * m * m * m * m * m


def shade(scene: Scene, idx, normal, in_dir, u1, u2, u3):
    """(bounce direction, unnormalized; attenuation on) of each hit."""
    g = lambda a: a.index_select(0, idx)
    mat, smooth, refl, ior = g(scene.mat_type), g(scene.smoothness), g(scene.reflectivity), g(
        scene.ior)
    is_metal, is_mirror, is_glass = mat == 1, mat == 2, mat == 3
    is_diffuse = ~(is_metal | is_mirror | is_glass)
    alpha_phong = torch.pow(torch.full_like(smooth, 1000.0), smooth)
    reflect_dir = _reflect(in_dir, normal)
    mirror_reflects = u3 < refl
    ddn = dot(in_dir, normal)
    inside = ddn > 0
    outward = where3(inside, scale(normal, -1.0), normal)
    eta = torch.where(inside, ior, 1.0 / torch.where(ior == 0, torch.ones_like(ior), ior))
    cos_arg = 1.0 - ior * ior * (1.0 - ddn * ddn)
    pos = cos_arg > 0
    cos_in = torch.sqrt(torch.where(pos, cos_arg, torch.ones_like(cos_arg)))
    cos_in = torch.where(pos, cos_in, torch.zeros_like(cos_in))
    cosine = torch.where(inside, cos_in, -ddn)
    refracted, ok = _refract(in_dir, outward, eta)
    reflect_prob = torch.where(ok, _schlick(cosine, ior), torch.ones_like(cosine))
    glass_reflects = u3 < reflect_prob
    two = torch.full_like(alpha_phong, 2.0)
    alpha = torch.where(is_diffuse, two,
                        torch.where(is_mirror & ~mirror_reflects, two, alpha_phong))
    base = where3(is_diffuse, normal,
                  where3(is_mirror, where3(mirror_reflects, reflect_dir, normal),
                         where3(is_glass, where3(glass_reflects, reflect_dir, refracted),
                                reflect_dir)))
    log_u = torch.log(torch.clamp(u1, min=1e-38))
    inv_a = 1.0 / alpha
    z = torch.exp(log_u * inv_a)
    y = 2.0 * log_u * inv_a
    r = torch.sqrt(torch.clamp(-torch.tanh(0.5 * y) * (torch.exp(y) + 1.0), min=0.0))
    phi = (2.0 * math.pi) * u2
    bounce = _to_world(r * torch.cos(phi), r * torch.sin(phi), z, base)
    return bounce, is_glass | (dot(normal, bounce) > 0)


# ---- sky (textures.cu:44-71, path_tracer.cu:117-122)


def _mirror(i, n):
    m = torch.remainder(i, 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def sky_radiance(sky, d):
    """Sky f32[H, W, 3] (in the scene's dtype) seen along directions d
    (planar): the four-tap bilinear fetch with mirror addressing."""
    dx, dy, dz = d
    safe_dx = torch.where(dx == 0, torch.full_like(dx, 1e-30), dx)
    v = div_exact(torch.asin(torch.clamp(dz, -1.0, 1.0)), math.pi) + 0.5
    u = div_exact(torch.atan(dy / safe_dx), 2.0 * math.pi)
    h, w = sky.shape[0], sky.shape[1]
    flat = sky.reshape(h * w, 3)
    xb = u * w - 0.5
    yb = v * h - 0.5
    x0f, y0f = torch.floor(xb), torch.floor(yb)
    fx, fy = (xb - x0f)[:, None], (yb - y0f)[:, None]
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    tap = lambda yy, xx: flat.index_select(0, _mirror(yy, h) * w + _mirror(xx, w))
    top = tap(y0, x0) * (1.0 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1.0 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1.0 - fy) + bot * fy


# ---- camera (motional_camera.cu:177-213)


class Camera:
    """A thin-lens camera's basis, worked out in `dtype` on `device`."""

    def __init__(self, origin, look_at, view_fov, width, height, device, dtype,
                 lens_radius=5e-4):
        f = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device).to(dtype)
        self.width, self.height, self.dtype = int(width), int(height), dtype
        self.origin, look_at = f(origin), f(look_at)
        self.lens = f(lens_radius)
        theta = f(view_fov) * (math.pi / 180.0)
        half_h = torch.tan(theta / 2.0)
        half_w = (f(float(width)) / f(float(height))) * half_h
        vec = lambda t: (t[0], t[1], t[2])
        w = normalize(vec(self.origin - look_at))
        vup = (f(0.0), f(1.0), f(0.0))
        u = normalize(cross(vup, w))
        v = cross(w, u)
        diff = vec(self.origin - look_at)
        focus = torch.sqrt(torch.clamp(dot(diff, diff), min=0.0))
        o = vec(self.origin)
        self.u, self.v = u, v
        self.top_left = tuple(o[k] - half_w * focus * u[k] + half_h * focus * v[k]
                              - focus * w[k] for k in range(3))
        self.horizontal = tuple(2.0 * half_w * focus * u[k] for k in range(3))
        self.vertical = tuple(-2.0 * half_h * focus * v[k] for k in range(3))

    def rays(self, pix, samp, seed: int):
        """(origin, direction) of the primary rays of int32 pixel indices
        (row-major y * W + x) at int32 sample keys."""
        x = (pix % self.width).to(self.dtype)
        y = torch.div(pix, self.width, rounding_mode="floor").to(self.dtype)
        r1, r2, _, _ = uniforms(seed, pix, samp, 0, self.dtype)
        rx, ry = self.lens * r1, self.lens * r2
        dx, dy = div_exact(x, float(self.width)), div_exact(y, float(self.height))
        off = tuple(rx * self.u[k] + ry * self.v[k] for k in range(3))
        o = tuple(self.origin[k] + off[k] for k in range(3))
        t_rel = tuple(self.top_left[k] + dx * self.horizontal[k] + dy * self.vertical[k]
                      - self.origin[k] - off[k] for k in range(3))
        return o, normalize(t_rel)


# ---- paths


class Paths:
    """What `trace` keeps of R paths: the radiance (without the sky), the
    sky seen by the escaped paths times their throughput, the first hit's
    normal and t, and, when asked, the record of each bounce (the object
    of each live hit, -1 otherwise, and whether it attenuates) and the sky
    seen by the escaped paths."""

    def __init__(self, rad, first_n, first_t, objs=None, atten=None, sky=None, live=0):
        self.rad, self.first_n, self.first_t = rad, first_n, first_t
        self.objs, self.atten, self.sky = objs, atten, sky
        self.live_ray_bounces = live


def trace(scene: Scene, camera: Camera, sky, pix, samp, seed: int, depth: int,
          record: bool = False, on_bounce=None) -> Paths:
    """Trace one sample of each (pixel, sample key) pair: `pix`, `samp`
    int32[R].  Only the paths still alive are searched at each bounce; a
    path that missed keeps its ray, which misses again.  Returns `Paths`
    with rad f32[R, 3] including the sky."""
    dt, dev = scene.dtype, scene.device
    r = pix.shape[0]
    o, d = camera.rays(pix, samp, seed)
    o, d = [c.clone() for c in o], [c.clone() for c in d]
    one = torch.ones(r, dtype=dt, device=dev)
    thru = [one.clone(), one.clone(), one.clone()]
    rad = [torch.zeros(r, dtype=dt, device=dev) for _ in range(3)]
    first_n, first_t = None, None
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    objs = torch.full((depth, r), -1, dtype=torch.int32, device=dev) if record else None
    atten = torch.zeros((depth, r), dtype=torch.bool, device=dev) if record else None
    live = hits = 0
    for b in range(depth):
        act = torch.nonzero(alive).squeeze(1) if b else torch.arange(r, device=dev)
        live += int(act.numel())
        if act.numel() == 0:
            break
        oa = tuple(c.index_select(0, act) for c in o)
        da = tuple(c.index_select(0, act) for c in d)
        tmin = torch.full((act.numel(),), 0.0 if b == 0 else TMIN_BOUNCE, dtype=dt, device=dev)
        if on_bounce is not None:
            on_bounce(oa, da, tmin)
        found = closest(scene, oa, da, tmin)
        idx = found.clamp(min=0)
        t, n = hit_attrs(scene, idx, oa, da, tmin)
        hit = (found >= 0) & (t < INF)
        hits += int(hit.sum())
        zero = torch.zeros_like(t)
        n = where3(hit, n, (zero, zero, zero))
        u1, u2, u3, _ = uniforms(seed, pix.index_select(0, act), samp.index_select(0, act),
                                 1 + b, dt)
        bounce, att_on = shade(scene, idx, n, da, u1, u2, u3)
        kd = scene.kd.index_select(0, idx)
        em = scene.emission.index_select(0, idx)
        lh = hit.to(dt)
        for k in range(3):
            ta = thru[k].index_select(0, act)
            rad[k].index_add_(0, act, ta * (kd[:, k] * em) * lh)
            att = torch.where(att_on, kd[:, k], zero)
            thru[k][act] = torch.where(hit, ta * att, ta)
        if b == 0:
            first_n = [torch.where(hit, n[k], -da[k]) for k in range(3)]
            first_t = torch.where(hit, t, torch.full_like(t, INF))
        if record:
            objs[b, act] = torch.where(hit, idx, torch.full_like(idx, -1)).to(torch.int32)
            atten[b, act] = att_on & hit
        ts = torch.where(hit, t, zero)
        nd = normalize(bounce)
        for k in range(3):
            o[k][act] = torch.where(hit, oa[k] + da[k] * ts, oa[k])
            d[k][act] = torch.where(hit, nd[k], da[k])
        alive[act] = hit
    missed = ~alive
    sky_val = sky_radiance(sky, tuple(d)) * missed[:, None].to(dt)
    thru_v = torch.stack(thru, dim=-1)
    rad_v = torch.stack(rad, dim=-1) + thru_v * sky_val
    out = Paths(rad_v, torch.stack(first_n, dim=-1), first_t, live=live)
    out.hits = hits
    if record:
        out.objs, out.atten, out.sky = objs, atten, sky_val
    return out


def replay_radiance(paths: Paths, kd, emission):
    """The radiance of recorded paths as a function of kd f[N, 3] and
    emission f[N] (the recurrence rad += thru * emission_b * kd_b, thru *=
    kd_b where the bounce attenuates, the sky times the final throughput),
    differentiable in both."""
    r = paths.objs.shape[1]
    thru = torch.ones((r, 3), dtype=kd.dtype, device=kd.device)
    rad = torch.zeros((r, 3), dtype=kd.dtype, device=kd.device)
    for b in range(paths.objs.shape[0]):
        obj = paths.objs[b].long()
        live = obj >= 0
        if not bool(live.any()):
            break
        idx = obj.clamp(min=0)
        kd_b = kd.index_select(0, idx)
        em_b = emission.index_select(0, idx)
        lv = live.to(kd.dtype)[:, None]
        rad = rad + thru * (kd_b * em_b[:, None]) * lv
        on = paths.atten[b].to(kd.dtype)[:, None]
        thru = torch.where(live[:, None], thru * kd_b * on, thru)
    return rad + thru * paths.sky.to(kd.dtype)


def render_pixels(scene: Scene, camera: Camera, sky, pix, seed: int, spp: int, depth: int,
                  sample_offset: int = 0, max_rays: int = 1 << 20):
    """Mean radiance over `spp` samples (keys sample_offset ...) of the
    pixels `pix` (int32), in float64 for float32 (the control's own dtype
    otherwise), and the live ray-bounces traced; the samples are traced in
    batches of at most `max_rays` rays."""
    r = pix.shape[0]
    acc = torch.zeros((r, 3), dtype=acc_dtype(scene.dtype), device=scene.device)
    live = 0
    per = max(1, max_rays // max(r, 1))
    for s0 in range(0, spp, per):
        n = min(per, spp - s0)
        p = pix.repeat(n)
        s = (torch.arange(n, dtype=torch.int32, device=pix.device) + sample_offset + s0
             ).repeat_interleave(r)
        paths = trace(scene, camera, sky, p, s, seed, depth)
        acc += paths.rad.to(acc.dtype).reshape(n, r, 3).sum(0)
        live += paths.live_ray_bounces
    return acc / spp, live
