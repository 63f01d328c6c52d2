"""Stream compaction / expansion for the split trace: wrappers and plain
PyTorch versions.

Counterpart of ``cpppathtracer_tpu/ops/pallas/compact_kernel.py``.  The
CUDA kernels are ``csrc/compact.cu``.  The pack is exact: the alive lanes
(missed == 0) of every payload plane go, in order, to lanes
[0, n_alive), and the lanes past n_alive hold the per-plane fill values.
The TPU's 128-lane "bubbles" do not exist here.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from cpppathtracer_tpu_torch.ops.cuda import build as kb


def _fill_bits(fill, dtype) -> int:
    """A fill value as the int32 bit pattern of a plane of `dtype`."""
    if dtype == torch.float32:
        return struct.unpack("<i", struct.pack("<f", float(fill)))[0]
    return int(fill)


def _check_planes(planes, r, dev):
    if not 0 < len(planes) <= 32:
        raise ValueError(f"1 to 32 planes are supported, got {len(planes)}")
    for k, t in enumerate(planes):
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"plane {k} has dtype {t.dtype}; float32 or int32 only")
        kb.require(t, f"plane {k}", t.dtype, (r,), dev)


def _ptr_array(ctype, values):
    return (ctype * len(values))(*values)


def stream_compact(missed, planes, fills):
    """Stably pack the alive lanes (missed == 0.0) of `planes`.

    missed f32[R]; planes: float32 or int32 [R] tensors; fills: one value
    per plane for the lanes past n_alive.  Returns (packed: list of [R]
    planes with the input dtypes, pos i32[R]: the original position of
    each packed lane (-1 past n_alive), n_alive i32[1] on the device).
    """
    dev = missed.device
    if dev.type == "cpu":
        return stream_compact_plain(missed, planes, fills)
    if dev.type != "cuda":
        raise ValueError(f"stream_compact runs on cuda or cpu tensors, got {dev}")
    r = missed.shape[0]
    kb.require(missed, "missed", torch.float32, (r,), dev)
    _check_planes(planes, r, dev)
    lib = kb.library()
    out = torch.empty((len(planes), r), dtype=torch.int32, device=dev)
    pos = torch.empty((r,), dtype=torch.int32, device=dev)
    n_alive = torch.empty((1,), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(1, lib.poca_compact_scratch_ints(r)),), dtype=torch.int32, device=dev)
    src = _ptr_array(ctypes.c_void_p, [p.data_ptr() for p in planes])
    fl = _ptr_array(ctypes.c_int, [_fill_bits(f, p.dtype) for f, p in zip(fills, planes)])
    with torch.cuda.device(dev):
        err = lib.poca_stream_compact(
            missed.data_ptr(), ctypes.cast(src, ctypes.c_void_p), len(planes),
            ctypes.cast(fl, ctypes.c_void_p), out.data_ptr(), pos.data_ptr(),
            n_alive.data_ptr(), scratch.data_ptr(), r, kb.stream_handle(missed),
        )
    kb.check(err, "stream_compact")
    kb.LAUNCHES["stream_compact"] += 1
    packed = [out[k].view(p.dtype) for k, p in enumerate(planes)]
    return packed, pos, n_alive


def stream_expand(missed, pos, packed, fills, n_alive):
    """Inverse of :func:`stream_compact` for planes computed in the packed
    domain: out[pos[k]] = packed[k] for k < n_alive (i32[1] on the device,
    as stream_compact returned it), and every lane with missed != 0 gets
    the fill.  Returns a list of [R] planes with the dtypes of `packed`."""
    dev = missed.device
    if dev.type == "cpu":
        return stream_expand_plain(missed, pos, packed, fills, n_alive)
    if dev.type != "cuda":
        raise ValueError(f"stream_expand runs on cuda or cpu tensors, got {dev}")
    r = missed.shape[0]
    kb.require(missed, "missed", torch.float32, (r,), dev)
    kb.require(pos, "pos", torch.int32, (r,), dev)
    kb.require(n_alive, "n_alive", torch.int32, (1,), dev)
    _check_planes(packed, r, dev)
    out = torch.empty((len(packed), r), dtype=torch.int32, device=dev)
    src = _ptr_array(ctypes.c_void_p, [p.data_ptr() for p in packed])
    fl = _ptr_array(ctypes.c_int, [_fill_bits(f, p.dtype) for f, p in zip(fills, packed)])
    with torch.cuda.device(dev):
        err = kb.library().poca_stream_expand(
            missed.data_ptr(), pos.data_ptr(), ctypes.cast(src, ctypes.c_void_p), len(packed),
            ctypes.cast(fl, ctypes.c_void_p), out.data_ptr(), n_alive.data_ptr(), r,
            kb.stream_handle(missed),
        )
    kb.check(err, "stream_expand")
    kb.LAUNCHES["stream_expand"] += 1
    return [out[k].view(p.dtype) for k, p in enumerate(packed)]


def stream_compact_plain(missed, planes, fills):
    """Plain PyTorch version of :func:`stream_compact` (no host sync)."""
    r = missed.shape[0]
    dev = missed.device
    alive = missed == 0.0
    csum = torch.cumsum(alive.to(torch.int32), 0, dtype=torch.int32)
    n_alive = csum[-1:].clone() if r else torch.zeros((1,), dtype=torch.int32, device=dev)
    # dead lanes scatter into a dump slot at index r
    dest = torch.where(alive, csum - 1, torch.full_like(csum, r)).long()
    past = torch.arange(r, device=dev) >= n_alive

    def pack(plane, fill):
        buf = torch.zeros((r + 1,), dtype=plane.dtype, device=dev)
        buf.scatter_(0, dest, plane)
        return torch.where(past, torch.full_like(plane, fill), buf[:r])

    pos = pack(torch.arange(r, dtype=torch.int32, device=dev), -1)
    return [pack(p, f) for p, f in zip(planes, fills)], pos, n_alive


def stream_expand_plain(missed, pos, packed, fills, n_alive):
    """Plain PyTorch version of :func:`stream_expand`."""
    r = missed.shape[0]
    dev = missed.device
    dead = missed != 0.0
    valid = torch.arange(r, device=dev) < n_alive
    dest = torch.where(valid, pos, torch.full_like(pos, r)).long()

    def unpack(plane, fill):
        buf = torch.zeros((r + 1,), dtype=plane.dtype, device=dev)
        buf.scatter_(0, dest, plane)
        return torch.where(dead, torch.full_like(plane, fill), buf[:r])

    return [unpack(p, f) for p, f in zip(packed, fills)]
