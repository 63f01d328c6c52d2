"""Stream compaction / expansion for the split trace: wrappers and plain
PyTorch versions.

Counterpart of ``cpppathtracer_tpu/ops/pallas/compact_kernel.py``.  The
CUDA kernels are ``csrc/compact.cu``.  The pack is exact: the alive lanes
(missed == 0) of every payload plane go, in order, to lanes [0, n_alive);
the lanes past n_alive are unspecified, as the Pallas kernel's stream
past its n_alive is.  The TPU's 128-lane "bubbles" do not exist here.
Both directions work on blocks of :data:`BLOCK` lanes: `offs[b]` is the
number of alive lanes before block b (the exact form of the Pallas
kernel's per-chunk `offs_rows`), and expansion reads each block's packed
run through it.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from cpppathtracer_tpu_torch.ops.cuda import build as kb

# lanes per block of both kernels (csrc/compact.cu POCA_CB)
BLOCK = 1024
MAX_PLANES = 32
_MAX_LANES = 1 << 30  # the look-back's status word keeps a count in 30 bits
_DTYPES = (torch.float32, torch.int32)


def n_blocks(r: int) -> int:
    return -(-r // BLOCK)


@functools.cache
def _lib():
    lib = kb.library()
    if lib.poca_compact_block_lanes() != BLOCK:
        raise RuntimeError(f"csrc/compact.cu works on blocks of {lib.poca_compact_block_lanes()} "
                           f"lanes, this module on {BLOCK}")
    return lib


@functools.lru_cache(maxsize=64)
def _fill_array(fills: tuple, is_float: tuple):
    """The fills as int32 bit patterns (float planes' as float32 bits)."""
    bits = [struct.unpack("<i", struct.pack("<f", float(f)))[0] if fl else int(f)
            for f, fl in zip(fills, is_float)]
    return (ctypes.c_int * len(bits))(*bits)


def _plane_ptrs(planes, r, dev):
    """Check the planes (float32 or int32 [R], contiguous, on `dev`) and
    return their pointers as a ctypes array and which are float."""
    if not 0 < len(planes) <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes are supported, got {len(planes)}")
    ptrs, is_float = [], []
    for k, t in enumerate(planes):
        if t.dtype not in _DTYPES or t.shape != (r,) or t.device != dev or not t.is_contiguous():
            raise ValueError(f"plane {k} is {t.dtype} {tuple(t.shape)} on {t.device}; expected "
                             f"contiguous float32 or int32 ({r},) on {dev}")
        ptrs.append(t.data_ptr())
        is_float.append(t.dtype == torch.float32)
    return (ctypes.c_void_p * len(ptrs))(*ptrs), tuple(is_float)


def _rows(buf, r, stride, is_float):
    """Rows [:r] of the planes that a 32-bit buffer holds at `stride`, as
    float32 or int32 views (one unbind; the int rows viewed again)."""
    rows = buf.view(torch.float32).as_strided((len(is_float), r), (stride, 1)).unbind(0)
    return [row if f else row.view(torch.int32) for row, f in zip(rows, is_float)]


def _check_missed(missed):
    dev = missed.device
    r = missed.shape[0] if missed.dim() == 1 else -1
    kb.require(missed, "missed", torch.float32, (r,), dev)
    if r >= _MAX_LANES:
        raise ValueError(f"at most {_MAX_LANES - 1} lanes are supported, got {r}")
    return dev, r


def stream_compact(missed, planes):
    """Stably pack the alive lanes (missed == 0.0) of `planes`.

    missed f32[R]; planes: float32 or int32 [R] tensors.  Returns (packed:
    list of [R] planes with the input dtypes, whose lanes [0, n_alive) hold
    the alive lanes in order and whose lanes past n_alive are unspecified;
    offs i32[ceil(R / BLOCK)]: the alive lanes before each block of BLOCK
    lanes; n_alive i32[1] on the device).
    """
    if missed.device.type == "cpu":
        return stream_compact_plain(missed, planes)
    if missed.device.type != "cuda":
        raise ValueError(f"stream_compact runs on cuda or cpu tensors, got {missed.device}")
    dev, r = _check_missed(missed)
    src, is_float = _plane_ptrs(planes, r, dev)
    n_p, nb, stride = len(planes), n_blocks(r), -(-r // 4) * 4
    # one allocation: the packed planes, offs, n_alive, then the look-back's
    # status words and ticket
    buf = torch.empty((n_p * stride + 2 * nb + 2,), dtype=torch.int32, device=dev)
    at = n_p * stride
    base = buf.data_ptr()
    with torch.cuda.device(dev):
        err = _lib().poca_stream_compact(
            missed.data_ptr(), src, n_p, base, stride, base + 4 * at, base + 4 * (at + nb),
            base + 4 * (at + nb + 1), r, kb.stream_handle(missed),
        )
    kb.check(err, "stream_compact")
    kb.LAUNCHES["stream_compact"] += 1
    return _rows(buf, r, stride, is_float), buf[at:at + nb], buf[at + nb:at + nb + 1]


def stream_expand(missed, offs, packed, fills):
    """Inverse of :func:`stream_compact` for planes computed in the packed
    domain: the k-th alive lane of `missed` (the compaction's miss plane)
    takes packed lane k, read through `offs` as stream_compact returned
    it; every other lane takes its plane's fill.  Packed lanes past the
    alive count are never read.  Returns a list of [R] planes with the
    dtypes of `packed`."""
    if missed.device.type == "cpu":
        return stream_expand_plain(missed, offs, packed, fills)
    if missed.device.type != "cuda":
        raise ValueError(f"stream_expand runs on cuda or cpu tensors, got {missed.device}")
    dev, r = _check_missed(missed)
    kb.require(offs, "offs", torch.int32, (n_blocks(r),), dev)
    src, is_float = _plane_ptrs(packed, r, dev)
    if len(fills) != len(packed):
        raise ValueError(f"{len(packed)} planes but {len(fills)} fills")
    n_p, stride = len(packed), -(-r // 4) * 4
    out = torch.empty((n_p * stride,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().poca_stream_expand(
            missed.data_ptr(), offs.data_ptr(), src, n_p, _fill_array(tuple(fills), is_float),
            out.data_ptr(), stride, r, kb.stream_handle(missed),
        )
    kb.check(err, "stream_expand")
    kb.LAUNCHES["stream_expand"] += 1
    return _rows(out, r, stride, is_float)


def _block_ranks(alive):
    """Per lane, the alive lanes before it within its block of BLOCK."""
    r = alive.shape[0]
    a = torch.nn.functional.pad(alive.to(torch.int32), (0, n_blocks(r) * BLOCK - r))
    a = a.view(-1, BLOCK)
    return (torch.cumsum(a, 1, dtype=torch.int32) - a).flatten()[:r]


def stream_compact_plain(missed, planes):
    """Plain PyTorch version of :func:`stream_compact` (no host sync); its
    lanes past n_alive hold zeros."""
    r = missed.shape[0]
    dev = missed.device
    alive = missed == 0.0
    csum = torch.cumsum(alive.to(torch.int32), 0, dtype=torch.int32)
    n_alive = csum[-1:].clone() if r else torch.zeros((1,), dtype=torch.int32, device=dev)
    starts = torch.arange(0, r, BLOCK, device=dev)
    offs = torch.where(starts > 0, csum[(starts - 1).clamp(min=0)], 0).to(torch.int32)
    # dead lanes scatter into a dump slot at index r
    dest = torch.where(alive, csum - 1, torch.full_like(csum, r)).long()

    def pack(plane):
        buf = torch.zeros((r + 1,), dtype=plane.dtype, device=dev)
        buf.scatter_(0, dest, plane)
        return buf[:r]

    return [pack(p) for p in planes], offs, n_alive


def stream_expand_plain(missed, offs, packed, fills):
    """Plain PyTorch version of :func:`stream_expand`, in the kernel's
    gather form: alive lane i of block b reads packed lane offs[b] + its
    rank in the block."""
    r = missed.shape[0]
    dev = missed.device
    alive = missed == 0.0
    block = torch.arange(r, device=dev) // BLOCK
    src = offs[block] + _block_ranks(alive)
    src = torch.where(alive, src, torch.zeros_like(src)).long()
    return [torch.where(alive, p[src], torch.full_like(p, f)) for p, f in zip(packed, fills)]
