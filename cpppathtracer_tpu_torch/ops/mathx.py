"""Scalar math helpers shared by the planar bounce body (counterpart of
``cpppathtracer_tpu/ops/mathx.py`` and ``ops/intersect._safe_div``)."""

from __future__ import annotations

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
