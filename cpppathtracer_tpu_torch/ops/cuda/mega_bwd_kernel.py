"""The megakernel's backward: wrapper and plain PyTorch version.

Counterpart of ``cpppathtracer_tpu/ops/pallas/mega_bwd_kernel.py::
pallas_mega_bwd``.  The CUDA kernel is ``csrc/mega_bwd.cu`` (its per-ray
body in ``csrc/mega_bwd.cuh``); :func:`mega_bwd_plain` is the same function
as torch autograd of the replay (``ops/mega.py::_replay_outputs``), which
the CPU runs and against which the kernel is held on the card.

The function: given the primary rays, the record tables, the saved winner
planes and the cotangents of the sample's outputs, the cotangents of the
rays and the tables.  Per ray, a forward sweep rebuilds each bounce's entry
carry (o, d, thru, alive) from the saved winners with no winner search;
a reverse sweep applies each bounce's adjoint.  ct_rad passes every bounce
unchanged; ct_first_n and ct_first_t enter at bounce 0 only.  The replay's
hit rule is the saved sign (`enc >= 0`), as in the JAX package's default
backward; its Pallas kernel also requires the recomputed t < INF, which the
port does not, so the kernel and its plain version agree with the replay.

A textured sample also passes `ct_aux`, the cotangents of the replay's
per-bounce aux outputs (the hit position and the attenuation mask times
the score-function weight): the Pallas kernel's `ct_pos` input, and the
`ct_att` that it lacks, so that this form computes the JAX package's
default textured backward (its replay's VJP) on the card.
"""

from __future__ import annotations

import torch

from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.utils.rng import seed_word

# ct_rad vec3, ct_miss_dir vec3, ct_miss_thru vec3, ct_first_n vec3, ct_first_t
N_COTANGENTS = 13
# The kernel keeps both tables in shared memory, and their cotangents too
# up to this n_pad (2 x 17 x 1024 floats = 136 KB); above it the
# cotangents go to device memory with global atomics.  Scenes of up to
# AUTO_BVH_THRESHOLD - 1 = 2047 objects (n_pad 2048, 139 KB of tables)
# take the megakernel.
SMEM_ACC_MAX_PAD = 1024
MAX_PAD = 2048


def mega_bwd(o, d, pixel_idx, sample_idx, seed, ts, trt, hits, ct, *, ct_aux=None,
             with_carry=False):
    """Cotangents of one megakernel sample.

    o, d: planar primary rays (tuples of f32[R]); pixel_idx, sample_idx
    i32[R]; seed an int or an i32 tensor of one element on the rays'
    device (read by the kernel there, as by ``mega_trace``); ts
    f32[13, n_pad], trt f32[4, n_pad]
    (`build_tables_T`); hits i32[depth, R], the saved winner planes;
    ct: the 13 f32[R] cotangent planes of (rad vec3, miss_dir vec3,
    miss_thru vec3, first_n vec3, first_t) (`missed` has none);
    ct_aux: None, or for a textured sample the 4 * depth f32[R] cotangent
    planes of its aux outputs in ``replay_vjp``'s order (per bounce pos
    vec3, then att), a sequence or one f32[4 * depth, R] tensor.  Those
    of a bounce that missed must be zero (the texture epilogue's are):
    the kernel does not read them.

    Returns (ct_ts f32[13, n_pad], ct_trt f32[4, n_pad], ct_o vec3, ct_d
    vec3).  With `with_carry`, also the rebuilt final carry (o vec3, d
    vec3, thru vec3, missed f32[R]), which equals `mega_trace`'s final
    origin, miss_dir, miss_thru and missed on the same inputs.

    CUDA tensors launch ``csrc/mega_bwd.cu``; CPU tensors take
    :func:`mega_bwd_plain`.
    """
    dev = pixel_idx.device
    if dev.type == "cpu":
        return mega_bwd_plain(o, d, pixel_idx, sample_idx, seed, ts, trt, hits, ct,
                              ct_aux=ct_aux, with_carry=with_carry)
    if dev.type != "cuda":
        raise ValueError(f"mega_bwd runs on cuda or cpu tensors, got {dev}")

    r = pixel_idx.shape[0]
    depth = hits.shape[0]
    n_pad = ts.shape[1]
    f32, i32 = torch.float32, torch.int32
    planes = list(o) + list(d)
    if len(planes) != 6 or len(ct) != N_COTANGENTS:
        raise ValueError("mega_bwd takes 3 + 3 ray planes and 13 cotangent planes")
    for k, t in enumerate(planes):
        kb.require(t, f"ray plane {k}", f32, (r,), dev)
    for k, t in enumerate(ct):
        kb.require(t, f"cotangent plane {k}", f32, (r,), dev)
    kb.require(pixel_idx, "pixel_idx", i32, (r,), dev)
    kb.require(sample_idx, "sample_idx", i32, (r,), dev)
    kb.require(ts, "ts", f32, (13, n_pad), dev)
    kb.require(trt, "trt", f32, (4, n_pad), dev)
    kb.require(hits, "hits", i32, (depth, r), dev)
    if ct_aux is not None:
        ct_aux = ct_aux if torch.is_tensor(ct_aux) else torch.stack(tuple(ct_aux))
        kb.require(ct_aux, "ct_aux", f32, (4 * depth, r), dev)
    if not 1 <= depth <= 32:
        raise ValueError(f"depth {depth} is outside [1, 32] (MAX_RECURSION_DEPTH_SET)")
    if n_pad > MAX_PAD:
        raise ValueError(f"n_pad {n_pad} > {MAX_PAD}: scenes that large take the BVH")

    seed_w = seed_word(seed, dev)

    out_tab = torch.zeros((17, n_pad), dtype=f32, device=dev)
    out_od = torch.empty((6, r), dtype=f32, device=dev)
    carry = torch.empty((10, r), dtype=f32, device=dev) if with_carry else None
    with torch.cuda.device(dev):
        err = kb.library().poca_mega_bwd(
            *[t.data_ptr() for t in planes], pixel_idx.data_ptr(), sample_idx.data_ptr(),
            ts.data_ptr(), trt.data_ptr(), hits.data_ptr(),
            *[t.data_ptr() for t in ct], kb.ptr(ct_aux),
            out_tab.data_ptr(), out_od.data_ptr(), kb.ptr(carry), seed_w.data_ptr(),
            r, n_pad, depth, int(n_pad <= SMEM_ACC_MAX_PAD), kb.stream_handle(pixel_idx),
        )
    kb.check(err, "mega_bwd")
    kb.LAUNCHES["mega_bwd"] += 1
    out = (out_tab[:13], out_tab[13:], tuple(out_od[0:3]), tuple(out_od[3:6]))
    if with_carry:
        out = out + ((tuple(carry[0:3]), tuple(carry[3:6]), tuple(carry[6:9]), carry[9]),)
    return out


def mega_bwd_plain(o, d, pixel_idx, sample_idx, seed, ts, trt, hits, ct, *, ct_aux=None,
                   with_carry=False):
    """Plain PyTorch version of :func:`mega_bwd` (same arguments and
    outputs), on any device: torch autograd of the replay,
    ``ops/mega.py::replay_vjp``."""
    # ops/mega.py imports this module for its backward, so its replay is
    # imported here, at call time
    from cpppathtracer_tpu_torch.ops.mega import replay_vjp

    if ct_aux is not None:
        ct_aux = tuple(ct_aux.unbind(0)) if torch.is_tensor(ct_aux) else tuple(ct_aux)
    return replay_vjp(o, d, pixel_idx, sample_idx, seed, ts, trt, hits, ct, ct_aux=ct_aux,
                      with_carry=with_carry)
