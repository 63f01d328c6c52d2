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


def schlick(cosine, ref_idx):
    """Schlick Fresnel approximation (`ray_tracing_math.hpp:65-69`)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = torch.clamp(1.0 - cosine, min=0.0)
    return r0 + (1.0 - r0) * m * m * m * m * m
