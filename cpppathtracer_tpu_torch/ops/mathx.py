"""Vector math (counterpart of ``cpppathtracer_tpu/ops/mathx.py`` and
``ops/intersect._safe_div``): the scalar helpers the planar bounce body
shares, and the row-major forms on f32[..., 3] tensors that the row-major
body uses (`include/ray_tracing_math.hpp:43-80`).

Every dot product and norm is written out as a0*b0 + a1*b1 + a2*b2, never
as a reduction: the order of a reduction over a length-3 axis is the
backend's choice, so the card and the CPU could round it differently.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-12


def safe_div(num, den):
    """num / den with a zero denominator replaced by 1 (the caller masks
    the result)."""
    return num / torch.where(den == 0.0, torch.ones_like(den), den)


def div_const(x, c: float):
    """x / c with a true IEEE division.  PyTorch's CUDA kernels turn a
    division by a python scalar into a multiplication by its reciprocal,
    which can differ in the last bit; a 0-dim device tensor keeps the
    division exact, as the JAX package computes it."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def clamp(x, lo=None, hi=None):
    """torch.clamp's value, with a gradient only where lo < x < hi strictly.

    torch.clamp also passes the gradient on a lane that sits exactly on a
    bound, where the sqrt, asin or rsqrt after it has an infinite slope, and
    0 * inf turns into NaN.  Here a clamped lane, on the bound or beyond it,
    sends no gradient: the rule the CUDA adjoints (csrc/mega_bwd.cuh)
    follow.  Without a graph to record it is torch.clamp itself.
    """
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, lo, hi)
    inside = torch.ones_like(x, dtype=torch.bool)
    if lo is not None:
        inside = inside & (x > lo)
    if hi is not None:
        inside = inside & (x < hi)
    return torch.where(inside, x, torch.clamp(x.detach(), lo, hi))


def schlick(cosine, ref_idx):
    """Schlick Fresnel approximation (`ray_tracing_math.hpp:65-69`)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = clamp(1.0 - cosine, lo=0.0)
    return r0 + (1.0 - r0) * m * m * m * m * m


# ---- row-major forms: 3-vectors are f32[..., 3] tensors


def dot(a, b):
    """Dot product over the last axis -> f32[...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(a):
    return torch.sqrt(clamp(dot(a, a), lo=0.0))


def normalize(v):
    """CUDA's normalize (the reciprocal square root of the squared
    length), 0 for a zero vector so that gradients stay finite."""
    n2 = dot(v, v)
    inv = torch.where(n2 > 0, 1.0 / torch.sqrt(clamp(n2, lo=EPS)), torch.zeros_like(n2))
    return v * inv[..., None]


def reflect(i, n):
    """i - 2 dot(i, n) n."""
    return i - 2.0 * dot(i, n)[..., None] * n


def to_world(a, n):
    """Local direction `a` (z up) into the frame around `n`
    (`ray_tracing_math.hpp:51-63`): the tangent C from the larger of |n.x|,
    |n.y|, B = C x N, a.x B + a.y C + a.z N."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = torch.abs(nx) > torch.abs(ny)
    zero = torch.zeros_like(nx)
    inv_len_x = 1.0 / torch.sqrt(clamp(nx * nx + nz * nz, lo=EPS))
    c_x = torch.stack([nz * inv_len_x, zero, -nx * inv_len_x], dim=-1)
    inv_len_y = 1.0 / torch.sqrt(clamp(ny * ny + nz * nz, lo=EPS))
    c_y = torch.stack([zero, nz * inv_len_y, -ny * inv_len_y], dim=-1)
    c = torch.where(use_x[..., None], c_x, c_y)
    b = cross(c, n)
    return a[..., 0:1] * b + a[..., 1:2] * c + a[..., 2:3] * n


def refract(v, n, ni_over_nt):
    """Snell refraction (`ray_tracing_math.hpp:71-80`): (dir f32[..., 3],
    ok bool[...]); the direction is zero where total internal reflection
    occurs.  The square root reads a dummy 1 on those lanes, so its
    infinite slope at 0 never meets a zero cotangent."""
    uv = normalize(v)
    dt = dot(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0
    safe_disc = torch.where(ok, disc, torch.ones_like(disc))
    refr = normalize(
        ni_over_nt[..., None] * (uv - n * dt[..., None]) - n * torch.sqrt(safe_disc)[..., None]
    )
    return torch.where(ok[..., None], refr, torch.zeros_like(refr)), ok


def phong_lobe_local(u1, u2, alpha):
    """The reference's Phong-style lobe in local coordinates
    (`material.cu:23-26`) -> f32[..., 3]: z = u1^(1/alpha), r^2 =
    -expm1(2 log(u1) / alpha) spelled -tanh(y/2) (e^y + 1), phi = 2 pi u2,
    as the JAX package computes it."""
    log_u = torch.log(clamp(u1, lo=1e-38))
    inv_a = 1.0 / alpha
    z = torch.exp(log_u * inv_a)
    y = 2.0 * log_u * inv_a
    neg_expm1 = -torch.tanh(0.5 * y) * (torch.exp(y) + 1.0)
    r = torch.sqrt(clamp(neg_expm1, lo=0.0))
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
