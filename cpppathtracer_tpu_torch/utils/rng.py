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


def _u32_bits(v: int) -> int:
    """A Python int's uint32 bit pattern as a signed 32-bit int."""
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def _as_i32(v, shape, device):
    """An int / integer-tensor key as int32 holding its uint32 bit pattern,
    broadcast to `shape`.  A Python int becomes a device fill, never a
    host-to-device copy, so the draw can be captured in a CUDA graph."""
    if isinstance(v, int):
        return torch.full((), _u32_bits(v), dtype=torch.int32, device=device).expand(shape)
    t = torch.as_tensor(v, device=device)
    if t.dtype != torch.int32:
        t = t.to(torch.int64) & 0xFFFFFFFF
        t = torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)
    return t.expand(shape)


def seed_word(seed, device) -> torch.Tensor:
    """The seed as the kernels read it: an i32[1] word on `device` holding
    its uint32 bit pattern.  `seed` is an int (a device fill, never a
    host-to-device copy, so the call can be captured in a CUDA graph) or an
    i32 tensor of one element on `device` (a graph's seed buffer, returned
    as a view, so a replay reads whatever was written into it)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != torch.device(device):
            raise ValueError(f"a seed tensor is an i32 tensor of one element on {device}, got "
                             f"{seed.dtype}{tuple(seed.shape)} on {seed.device}")
        return seed.reshape(1)
    return torch.full((1,), _u32_bits(int(seed)), dtype=torch.int32, device=device)


def write_seed(buf: torch.Tensor, seed):
    """Write `seed` (an int, or an i32 tensor of one element on buf's
    device) into a graph's seed buffer `buf` (i32, one element), as its
    uint32 bit pattern."""
    if isinstance(seed, torch.Tensor):
        buf.copy_(seed_word(seed, buf.device).reshape(buf.shape))
    else:
        buf.fill_(_u32_bits(int(seed)))


def sample_key(sample_idx, r: int, device):
    """The per-ray sample index i32[r] of a sample: `sample_idx` an int (a
    device fill) or an integer tensor of one value or of r (a device tensor
    when the key lives in a CUDA graph's buffer)."""
    if isinstance(sample_idx, torch.Tensor):
        return sample_idx.to(device=device, dtype=torch.int32).expand(r).contiguous()
    return torch.full((r,), int(sample_idx), dtype=torch.int32, device=device)


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
