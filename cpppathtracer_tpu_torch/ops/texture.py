"""Texture sampling and the sky environment map (counterpart of
``cpppathtracer_tpu/ops/texture.py``).

CUDA texture semantics of the reference (`cuSrc/textures.cu:44-71`):
normalized coordinates, bilinear filtering at (u*W - 0.5, v*H - 0.5),
mirror addressing.  The sky miss shader maps a direction to
  v = asin(d.z)/pi + 0.5 ;  u = atan(d.y / d.x) / (2 pi)
(`cuSrc/path_tracer.cu:117-122`), plain atan, so negative u relies on the
mirror addressing.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cpppathtracer_tpu_torch.ops.mathx import clamp, div_const


def _remainder(x, y: float):
    """x mod y with the sign of y (numpy/JAX `%` on floats): fmod, then
    one add where the signs disagree."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _mirror_index(i, n):
    m = torch.remainder(i, 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def sample_bilinear(tex, u, v):
    """Bilinear fetch with mirror addressing.  tex f32[H,W,C]; u, v
    f32[...] normalized.  Returns f32[..., C].  The four taps are
    index_select row gathers (see ``planar.gather_epilogue_p`` for why),
    differentiable in tex and, through the weights, in u and v."""
    h, w = tex.shape[0], tex.shape[1]
    flat = tex.reshape(h * w, -1)
    tap = lambda yy, xx: flat.index_select(0, (yy * w + xx).flatten()).reshape(
        *yy.shape, flat.shape[1])
    xb = u * w - 0.5
    yb = v * h - 0.5
    x0f = torch.floor(xb)
    y0f = torch.floor(yb)
    fx = (xb - x0f)[..., None]
    fy = (yb - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x0m, x1m = _mirror_index(x0, w), _mirror_index(x0 + 1, w)
    y0m, y1m = _mirror_index(y0, h), _mirror_index(y0 + 1, h)
    top = tap(y0m, x0m) * (1.0 - fx) + tap(y0m, x1m) * fx
    bot = tap(y1m, x0m) * (1.0 - fx) + tap(y1m, x1m) * fx
    return top * (1.0 - fy) + bot * fy


def sky_uv(dir_xyz):
    """Direction f32[..., 3] -> env-map (u, v), with the 0/0 case at
    d = +-y guarded (the reference gives NaN there)."""
    dx, dy, dz = dir_xyz[..., 0], dir_xyz[..., 1], dir_xyz[..., 2]
    safe_dx = torch.where(dx == 0, torch.full_like(dx, 1e-30), dx)
    v = div_const(torch.asin(clamp(dz, -1.0, 1.0)), math.pi) + 0.5
    u = div_const(torch.atan(dy / safe_dx), 2.0 * math.pi)
    return u, v


def sample_sky(tex, dir_xyz):
    """Sky radiance f32[..., 3] for normalized directions f32[..., 3]: the
    four-tap bilinear fetch.  The render paths sample the sky with the
    quad-packed form, :func:`sample_sky_packed`, as the JAX package's do."""
    u, v = sky_uv(dir_xyz)
    return sample_bilinear(tex, u, v)


def load_texture(path) -> np.ndarray:
    """An image file as f32[H,W,3] in [0,1] (`textures.cu:14-62`)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def procedural_sky(height: int = 256, width: int = 256, seed: int = 0) -> np.ndarray:
    """Deterministic built-in sky (gradient + sun disc + soft clouds), the
    JAX package's default environment."""
    rng = np.random.RandomState(seed)
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    horizon = np.array([0.9, 0.85, 0.75], np.float32)
    zenith = np.array([0.25, 0.45, 0.85], np.float32)
    t = np.abs(y - 0.5) * 2.0
    base = horizon * (1 - t[..., None]) + zenith * t[..., None]
    sun_u, sun_v = 0.1, 0.75
    d2 = (x - sun_u) ** 2 + (y - sun_v) ** 2
    sun = np.exp(-d2 / 0.002)[..., None] * np.array([3.0, 2.7, 2.2], np.float32)
    clouds = np.zeros((height, width), np.float32)
    for k in range(1, 5):
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        clouds += np.sin(2 * np.pi * k * x + ph1) * np.sin(2 * np.pi * k * y + ph2) / k
    clouds = np.clip(clouds, 0, None)[..., None] * 0.15
    return np.clip(base + sun + clouds, 0.0, 1.0).astype(np.float32)


# Quad-packed sampling: each texel's clamped 2x2 neighbourhood is one
# 16-float row (t00 t01 t10 t11 pad), so a sample is one row gather.
# Mirror addressing is folded into the continuous coordinate first, which
# equals CUDA's mirror + linear filtering (fx forced to 0 on the x0 = -1
# boundary strip, where both taps are texel 0).  One quad per row: the JAX
# package's default fold of 1.


@dataclasses.dataclass
class PackedTexture:
    data: torch.Tensor  # f32[H*W, 16]
    shape: tuple  # (H, W)


def pack_bilinear(tex) -> PackedTexture:
    """The quad-packed table of tex f32[H,W,3]."""
    h, w = tex.shape[0], tex.shape[1]
    xn = torch.clamp(torch.arange(w, device=tex.device) + 1, max=w - 1)
    yn = torch.clamp(torch.arange(h, device=tex.device) + 1, max=h - 1)
    pad = torch.zeros((h, w, 4), dtype=torch.float32, device=tex.device)
    packed = torch.cat([tex, tex[:, xn], tex[yn, :], tex[yn][:, xn], pad], dim=-1)
    return PackedTexture(data=packed.reshape(h * w, 16).contiguous(), shape=(h, w))


def _fold_axis(coord, n):
    """Reflect a continuous texel coordinate into [0, n] (period 2n)."""
    m = _remainder(coord, 2.0 * n)
    return torch.where(m > n, 2.0 * n - m, m)


def sample_packed(pt: PackedTexture, u, v):
    h, w = pt.shape
    xb = _fold_axis(u * w, w) - 0.5
    yb = _fold_axis(v * h, h) - 0.5
    x0 = torch.floor(xb)
    y0 = torch.floor(yb)
    zero = torch.zeros_like(xb)
    fx = torch.where(x0 < 0, zero, xb - x0)[..., None]
    fy = torch.where(y0 < 0, zero, yb - y0)[..., None]
    xi = torch.clamp(x0, min=0.0).to(torch.int64)
    yi = torch.clamp(y0, min=0.0).to(torch.int64)
    row = pt.data[yi * w + xi]  # [..., 16]
    top = row[..., 0:3] * (1.0 - fx) + row[..., 3:6] * fx
    bot = row[..., 6:9] * (1.0 - fx) + row[..., 9:12] * fx
    return top * (1.0 - fy) + bot * fy


def sample_sky_packed(pt: PackedTexture, dir_xyz):
    u, v = sky_uv(dir_xyz)
    return sample_packed(pt, u, v)
