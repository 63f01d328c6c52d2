"""Surface UV parameterization for per-material albedo textures
(counterpart of ``cpppathtracer_tpu/ops/uv.py``).

The reference fetches `Material::GetKd(x, y)` in every hit shader
(`cuSrc/material.cu:11-18`) but never passes it hit UVs; the JAX package
gives each primitive the natural parameterization below, and the port
keeps it:

  sphere    u = atan2(p.z - c.z, p.x - c.x)/(2 pi) + 0.5 ;
            v = asin(clamp((p.y - c.y)/r)) / pi + 0.5
  platform  u = p.x * 0.01 ; v = p.z * 0.01   (world-grid tiling)
  cylinder  u = atan2(z, x)/(2 pi) + 0.5 ; v = (p.y - y_bot)/height

`surface_uv_p` serves the planar bounce body and the megakernel's
textured epilogue, `surface_uv` the row-major body.
"""

from __future__ import annotations

import math

import torch

from cpppathtracer_tpu_torch.ops.mathx import clamp, div_const
from cpppathtracer_tpu_torch.types import PrimitiveType


def surface_uv_p(prim_type, center, radius, y_pos, height, pos):
    """Hit UVs of each lane on its object.  center and pos are planar vec3
    tuples of f32[R], the rest f32[R] (prim_type int); returns (u, v)
    f32[R].  A zero radius or height is replaced by 1 before the divide,
    and the sphere's asin argument is clamped to [-1, 1]."""
    cx, cy, cz = center
    px, py, pz = pos
    relx, rely, relz = px - cx, py - cy, pz - cz
    # sphere
    su = div_const(torch.atan2(relz, relx), 2.0 * math.pi) + 0.5
    safe_r = torch.where(radius == 0.0, torch.ones_like(radius), radius)
    sv = div_const(torch.asin(clamp(rely / safe_r, -1.0, 1.0)), math.pi) + 0.5
    # platform
    pu = px * 0.01
    pv = pz * 0.01
    # cylinder: u as the sphere's
    safe_h = torch.where(height == 0.0, torch.ones_like(height), height)
    cv = (py - (cy - height / 2.0)) / safe_h

    is_sph = prim_type == PrimitiveType.SPHERE
    is_pla = prim_type == PrimitiveType.PLATFORM
    u = torch.where(is_sph, su, torch.where(is_pla, pu, su))
    v = torch.where(is_sph, sv, torch.where(is_pla, pv, cv))
    return u, v


def surface_uv(prim_type, center, radius, y_pos, height, pos):
    """Row-major form of :func:`surface_uv_p`: every field gathered per
    ray (f32[...] / f32[..., 3], prim_type int); returns (u, v) f32[...]."""
    return surface_uv_p(prim_type, tuple(center.unbind(-1)), radius, y_pos, height,
                        tuple(pos.unbind(-1)))
