"""The wavefront path's bounce body: the PyTorch body, its kernel's wrapper
and its plain version.

Replaces no Pallas kernel: ``csrc/wavefront.cu`` is the hand-written
counterpart of what XLA fuses out of the JAX package's per-bounce body
around the winner search.  :func:`bounce_p` is that body in PyTorch, one
bounce of ``integrator.trace_bounces`` given each lane's winner: record
fetch and hit recomputation (``planar.gather_epilogue_p``), PCG4D uniforms,
BSDF sampling (``planar.shade_p``) and the carry updates.
``trace_bounces`` runs it wherever the kernel does not (CPU tensors,
autograd, textures, the backward's replay); :func:`wavefront_bounce_plain`
runs it on the kernel's planes, and the kernel is held bitwise against it.
"""

from __future__ import annotations

import torch

from cpppathtracer_tpu_torch.ops import planar
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.types import INF, TMIN_BOUNCE
from cpppathtracer_tpu_torch.utils.rng import seed_word, uniforms4


def bounce_p(table_s, table_r, carry, gidx, tmin, tmax, pixel_idx, sample_idx, seed, b: int, *,
             kd_of=None):
    """Bounce `b` of the planar wavefront body for winners `gidx` (i32[R]).

    carry = (o vec3, d vec3, thru vec3, rad vec3, alive bool[R]); table_s,
    table_r the record tables (``ops/fast.py``'s columns, or float64
    copies); tmin, tmax f32[R].  `kd_of(mats, hitrec)`, when given, returns
    the attenuation's albedo (the textured kd).  Returns (the carry after
    the bounce, the recomputed hit bool[R], first), first = (first_n vec3,
    first_t f32[R]) at b == 0 and None after.  A path that missed keeps its
    ray."""
    o, d, thru, rad, alive = carry
    hit, mats = planar.gather_epilogue_p(table_s, table_r, o, d, tmin, tmax, gidx)
    u1, u2, u3, _ = uniforms4(seed, pixel_idx, sample_idx, 1 + b)
    kd_override = None if kd_of is None else kd_of(mats, hit)
    # the score-function weight is 1.0 in value: only a graph needs it
    bounce_dir, attenuation, emitted = planar.shade_p(
        mats, hit["normal"], d, u1, u2, u3, kd_override=kd_override,
        score_grad=torch.is_grad_enabled(),
    )
    live_hit = hit["hit"] & alive
    lh = live_hit.to(torch.float32)
    rad = planar.add_p(rad, planar.scale_p(planar.mul_p(thru, emitted), lh))
    thru = planar.where_p(live_hit, planar.mul_p(thru, attenuation), thru)
    first = None
    if b == 0:
        first = (planar.where_p(hit["hit"], hit["normal"], planar.scale_p(d, -1.0)), hit["t"])
    alive = alive & hit["hit"]
    o = planar.where_p(hit["hit"], hit["pos"], o)
    d = planar.where_p(hit["hit"], planar.normalize_p(bounce_dir), d)
    return (o, d, thru, rad, alive), hit["hit"], first


def field_major_tables(table_s, table_r):
    """The record tables as the kernel reads them: (ts f32[13, N], trt
    f32[4, N]), a field's values of every record contiguous."""
    return table_s.T.contiguous(), table_r.T.contiguous()


def carry_parts(carry):
    """(o, d, thru, rad), each a tuple of three f32[R] views of the carry
    planes f32[12, R]."""
    return tuple(tuple(carry[3 * k:3 * k + 3]) for k in range(4))


def start_planes(o, d):
    """The kernel's planes at bounce 0 for primary rays o, d (tuples of
    f32[R]): carry f32[12, R] (o, d, thru = 1, rad = 0), alive bool[R] (all
    true) and first f32[4, R] (zeros until bounce 0 writes it)."""
    r = o[0].shape[0]
    dev = o[0].device
    carry = torch.cat([torch.stack(o), torch.stack(d),
                       torch.ones((3, r), dtype=torch.float32, device=dev),
                       torch.zeros((3, r), dtype=torch.float32, device=dev)])
    return (carry, torch.ones((r,), dtype=torch.bool, device=dev),
            torch.zeros((4, r), dtype=torch.float32, device=dev))


def wavefront_bounce(carry, alive, first, gidx, pix, samp, seed, ts, trt, *, bounce: int):
    """Bounce `bounce` of the wavefront body over R lanes, in place.

    carry f32[12, R] (o, d, thru, rad, three planes each) and alive bool[R]
    are read and updated; first f32[4, R] (first_n, first_t) is written at
    bounce 0; gidx i32[R] is each lane's winner (< N, as the walk and the
    dense search return it); pix, samp i32[R]; seed an int or an i32 tensor
    of one element on the planes' device (the kernel reads it there, so a
    captured launch replays any seed written into it); ts, trt from
    :func:`field_major_tables`.

    CUDA tensors launch ``csrc/wavefront.cu``, counted in
    ``build.LAUNCHES["wavefront_bounce"]``; CPU tensors take
    :func:`wavefront_bounce_plain`."""
    dev = carry.device
    if dev.type == "cpu":
        return wavefront_bounce_plain(carry, alive, first, gidx, pix, samp, seed, ts, trt,
                                      bounce=bounce)
    if dev.type != "cuda":
        raise ValueError(f"wavefront_bounce runs on cuda or cpu tensors, got {dev}")
    r = carry.shape[1]
    f32, i32 = torch.float32, torch.int32
    kb.require(carry, "carry", f32, (12, r), dev)
    kb.require(alive, "alive", torch.bool, (r,), dev)
    kb.require(first, "first", f32, (4, r), dev)
    for name, t in (("gidx", gidx), ("pix", pix), ("samp", samp)):
        kb.require(t, name, i32, (r,), dev)
    n_tab = ts.shape[1]
    kb.require(ts, "ts", f32, (13, n_tab), dev)
    kb.require(trt, "trt", f32, (4, n_tab), dev)
    seed_w = seed_word(seed, dev)
    with torch.cuda.device(dev):
        err = kb.library().poca_wavefront_bounce(
            *[t.data_ptr() for t in (carry, alive, first, gidx, pix, samp, seed_w, ts, trt)],
            r, n_tab, bounce, kb.stream_handle(carry),
        )
    kb.check(err, "wavefront_bounce")
    kb.LAUNCHES["wavefront_bounce"] += 1


def wavefront_bounce_plain(carry, alive, first, gidx, pix, samp, seed, ts, trt, *, bounce: int):
    """Plain PyTorch version of :func:`wavefront_bounce` (same arguments,
    same in-place updates), on any device: :func:`bounce_p` on the
    planes."""
    zero = torch.zeros_like(carry[0])
    tmin = zero + (0.0 if bounce == 0 else TMIN_BOUNCE)
    (o, d, thru, rad, now_alive), _, fst = bounce_p(ts.T, trt.T, (*carry_parts(carry), alive),
                                                    gidx, tmin, zero + INF, pix, samp, seed,
                                                    bounce)
    carry.copy_(torch.stack([*o, *d, *thru, *rad]))
    alive.copy_(now_alive)
    if fst is not None:
        first.copy_(torch.stack([*fst[0], fst[1]]))
