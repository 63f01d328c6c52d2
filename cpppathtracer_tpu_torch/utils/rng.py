"""Counter-based, stateless PCG4D uniforms (counterpart of
``cpppathtracer_tpu/utils/rng.py``).

Every draw is a pure function of ``(seed, pixel, sample, counter)``, so the
plain PyTorch path, the CUDA kernel and the JAX package draw bitwise-equal
numbers.  PyTorch has no arithmetic on uint32 tensors, so the hash runs on
int32 tensors, whose sums and products wrap modulo 2^32 exactly as uint32
ones do; only the right shift differs (it is arithmetic), so each logical
shift is written ``(v >> k) & mask``.
"""

from __future__ import annotations

import torch

CTR_RAYGEN = 0

_INV_2_24 = float(2.0**-24)


def _pcg4d(x, y, z, w):
    """One PCG4D evaluation on int32 tensors holding uint32 bit patterns."""
    mul, add = 1664525, 1013904223
    x = x * mul + add
    y = y * mul + add
    z = z * mul + add
    w = w * mul + add
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


def _as_i32(v, shape, device):
    """An int / integer-tensor key as int32 holding its uint32 bit pattern,
    broadcast to `shape`."""
    t = torch.as_tensor(v, device=device)
    if t.dtype != torch.int32:
        t = t.to(torch.int64) & 0xFFFFFFFF
        t = torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)
    return t.expand(shape)


def uniforms4(seed, pixel, sample, ctr):
    """Four U[0,1) float32 tensors per (seed, pixel, sample, ctr) key.
    The arguments broadcast; `pixel` must be a tensor (it sets the device)."""
    device = pixel.device
    shape = torch.broadcast_shapes(
        *(torch.as_tensor(v).shape for v in (seed, sample, ctr)), pixel.shape
    )
    a, b, c, d = _pcg4d(
        _as_i32(pixel, shape, device),
        _as_i32(sample, shape, device),
        _as_i32(ctr, shape, device),
        _as_i32(seed, shape, device),
    )
    to_f = lambda v: ((v >> 8) & 0xFFFFFF).to(torch.float32) * _INV_2_24
    return to_f(a), to_f(b), to_f(c), to_f(d)
