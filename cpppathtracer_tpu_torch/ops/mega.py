"""One integrator sample through the megakernel, differentiable.

Counterpart of ``cpppathtracer_tpu/ops/mega.py``: `mega_sample` (its
`custom_vjp`), `_kernel_forward`, and the replay `_replay_chain` /
`_replay_outputs` that defines the backward.

Forward, survivor split: on the demo scene only about a fifth of the rays
survive bounce 1, and the survivors are scattered over the pixels, so the
trace runs bounces [0, 2) on every ray (phase A), packs the survivors to a
dense prefix (stream_compact; its lanes past n_alive are unspecified and
never read), runs the later bounces on the packed domain (phase B, whose
kernel traces only the first n_alive lanes) and routes phase B's outputs
back to their pixels (stream_expand, through the compaction's per-block
offsets).
RNG keys are per (pixel, sample, bounce), so the traced paths are bitwise
those of the unsplit trace; radiance differs only in the order of its
float32 sum.

The JAX package can also schedule phase B as a static-prefix ladder with
a second split (`ops/mega.py:454-691`), a TPU tuning schedule that the
port does not have, nor the switches that choose it: the port runs phase
B as one launch over every packed lane.  On the H100 a 1024^2 x d8 demo
sample took 1.6979-1.7057 ms of device time with the ladder and second
split, and 1.5338-1.5399 ms with the single launch (README).
POCA_MEGA_SPLIT, the split bounce (0 for an unsplit trace), is honoured.

Backward: the forward saves only the primary rays, the record tables and
the per-bounce winner planes (i32[depth, R], the winner's grouped index on
a hit, -1 on a miss).  The replay rebuilds every bounce from the saved
winner, with no winner search, and its gradient is the sample's gradient.
On the card the hand-written kernel ``csrc/mega_bwd.cu`` computes it; on
the CPU, torch autograd of :func:`_replay_outputs`.  The JAX package's
split replay, 16-bit residual packing and layout firewall are TPU memory
and layout devices and are not ported.

Textured scenes (`with_aux`): the forward also returns the kernel's
per-bounce hit positions and attenuation-on masks, which the texture
epilogue (``integrator._mega_tex_radiance``) reads.  Their backward is
``mega_bwd(ct_aux=...)``: on the card the kernel's textured instance,
which takes the cotangents of the replayed positions and of the replayed
mask (which carries the score-function weight); on the CPU torch autograd
of ``_replay_outputs(with_aux=True)``.  That is the function the JAX
package computes for textured samples by autograd of its replay
(`ops/mega.py:993-996`): its Pallas backward takes the positions'
cotangents but not the mask's.
"""

from __future__ import annotations

import os

import torch

from cpppathtracer_tpu_torch.ops import planar
from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import MAX_PLANES, stream_compact, stream_expand
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T, mega_trace
from cpppathtracer_tpu_torch.types import INF, TMIN_BOUNCE, MaterialType
from cpppathtracer_tpu_torch.utils.rng import sample_key, uniforms4

_MEGA_TILE = 1024
_SPLIT = 2


def _pick_tile(r: int) -> int:
    """The JAX package's ray tile for R rays (`ops/fast.py:368`)."""
    for tile in (8192, 4096, 2048, 1024, 512, 256):
        if r % tile == 0:
            return tile
    return 8192 if r > 8192 else 256


def _split_plan(r: int, depth: int) -> int:
    """The bounce at which the trace splits, 0 for an unsplit trace: the
    JAX package's rule (`ops/mega.py:329-348`), which splits at bounce S
    (POCA_MEGA_SPLIT, default 2; 0 turns the split off) when phase B has
    at least two bounces and R spans at least four megakernel tiles."""
    env = os.environ.get("POCA_MEGA_SPLIT", "")
    split = int(env) if env.lstrip("-").isdigit() else _SPLIT
    tile = min(_MEGA_TILE, _pick_tile(r))
    r_pad = -(-r // tile) * tile
    return split if split > 0 and depth - split >= 2 and r_pad >= 4 * tile else 0


# ------------------------------------------------------------------ replay


def _replay_chain(ts, trt, o, d, thru, rad, alive, hit_planes, pixel_idx, sample_idx, seed,
                  with_aux=False):
    """Bounces [0, len(hit_planes)) rebuilt from the saved winner planes
    (the JAX package's `_replay_chain` from bounce 0: its later start
    serves only the split replay, which is not ported).

    The hit attributes are recomputed from the saved winner, so geometry
    gradients flow through t and the normal, but the saved sign alone
    decides whether the bounce hit (`hit = enc >= 0`): the value being
    differentiated is the one the kernel's chain produced
    (`tests/test_mega.py:260`).  Returns the carry (o, d, thru, rad, alive),
    the first-bounce records (first_n, first_t) and, with `with_aux`, per
    bounce (pos vec3, att): the attenuation-on mask times the
    score-function weight (1.0 in value) times the saved hit, so that
    the reflectivity and Fresnel gradients of textured scenes flow through
    the epilogue's use of it (JAX `ops/mega.py:125-146`).
    """
    # The records are gathered from float64 copies of the tables and read
    # back as float32, so the values are unchanged, but autograd sums each
    # table cotangent over the R lanes in float64: a float32 sum over a
    # million lanes loses about 1e-3 on the row of an object most rays hit.
    table_s, table_r = ts.T.double(), trt.T.double()
    zero = torch.zeros_like(o[0])
    first_n = (zero, zero, zero)
    first_t = zero
    tmax = zero + INF
    aux = []
    for b, enc in enumerate(hit_planes):
        tmin = zero + (0.0 if b == 0 else TMIN_BOUNCE)
        hitrec, mats = planar.gather_epilogue_p(
            table_s, table_r, o, d, tmin, tmax, torch.clamp(enc, min=0)
        )
        hit = enc >= 0
        u1, u2, u3, _ = uniforms4(seed, pixel_idx, sample_idx, 1 + b)
        bounce_dir, attenuation, emitted, score_w = planar.shade_p(
            mats, hitrec["normal"], d, u1, u2, u3, with_score=True
        )
        if with_aux:
            att_on = (mats["mat_type"] == MaterialType.GLASS) | (
                planar.dot_p(hitrec["normal"], bounce_dir) > 0.0
            )
            aux.append((hitrec["pos"], att_on.to(torch.float32) * score_w * hit.to(torch.float32)))
        live_hit = hit & alive
        lh = live_hit.to(torch.float32)
        rad = planar.add_p(rad, planar.scale_p(planar.mul_p(thru, emitted), lh))
        thru = planar.where_p(live_hit, planar.mul_p(thru, attenuation), thru)
        if b == 0:
            first_n = planar.where_p(hit, hitrec["normal"], planar.scale_p(d, -1.0))
            first_t = torch.where(hit, hitrec["t"], tmax)
        alive = alive & hit
        o = planar.where_p(hit, hitrec["pos"], o)
        d = planar.where_p(hit, planar.normalize_p(bounce_dir), d)
    return o, d, thru, rad, alive, first_n, first_t, aux


def _replay_outputs(o, d, ts, trt, pixel_idx, sample_idx, seed, hit_planes, with_aux=False):
    """The megakernel's outputs rebuilt from the primary rays (o, d) and the
    saved winner planes: (rad, miss_dir, miss_thru, missed, first_n,
    first_t), plus the final origin, as `mega_trace` returns them, and
    with `with_aux` the per-bounce (pos, att) of :func:`_replay_chain`."""
    zero = torch.zeros_like(o[0])
    one = zero + 1.0
    o, d, thru, rad, alive, first_n, first_t, aux = _replay_chain(
        ts, trt, o, d, (one, one, one), (zero, zero, zero), zero < 1.0, hit_planes,
        pixel_idx, sample_idx, seed, with_aux,
    )
    missed = (~alive).to(torch.float32)
    out = (rad, d, thru, missed, first_n, first_t, o)
    return out + (tuple(aux),) if with_aux else out


def replay_vjp(o, d, pixel_idx, sample_idx, seed, ts, trt, hits, ct, *, ct_aux=None,
               with_carry=False):
    """Cotangents (ct_ts, ct_trt, ct_o, ct_d) of one sample by torch
    autograd of :func:`_replay_outputs`, given the 13 cotangents of
    (rad, miss_dir, miss_thru, first_n, first_t) and, for a textured
    sample, `ct_aux`, those of its 4 * depth aux planes.  With
    `with_carry`, also the rebuilt final carry (o, d, thru, missed).
    It is ``mega_bwd_plain``, the plain version of ``csrc/mega_bwd.cu``,
    in both forms."""
    with_aux = ct_aux is not None
    leaves = [t.detach().requires_grad_() for t in (*o, *d, ts, trt)]
    with torch.enable_grad():
        rad, md, mt, missed, fn, ft, o_f, *aux = _replay_outputs(
            tuple(leaves[0:3]), tuple(leaves[3:6]), leaves[6], leaves[7], pixel_idx,
            sample_idx, seed, tuple(hits.unbind(0)), with_aux=with_aux,
        )
        outs = [*rad, *md, *mt, *fn, ft] + [c for pos, att in (aux[0] if aux else ())
                                             for c in (*pos, att)]
        cts = list(ct) + (list(ct_aux) if with_aux else [])
        used = [k for k, y in enumerate(outs) if y.requires_grad]
        grads = torch.autograd.grad([outs[k] for k in used], leaves,
                                    grad_outputs=[cts[k] for k in used], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    out = (grads[6], grads[7], tuple(grads[0:3]), tuple(grads[3:6]))
    if with_carry:
        det = lambda v: tuple(c.detach() for c in v)
        out = out + ((det(o_f), det(md), det(mt), missed),)
    return out


# ---------------------------------------------------------------- forward


def _trace(o, d, pix, samp, seed, depth, geom, ts, trt, counts, with_aux=False):
    """The megakernel's forward of one sample, split where `_split_plan`
    says, its phase B one launch over the packed lanes.  Returns (rad,
    miss_dir, miss_thru, missed, first_n, first_t, hit planes, aux planes:
    4 per bounce (pos vec3, att) with `with_aux`, else none).  Phase B's
    aux planes return to their pixels with fill 0.0, as its other outputs
    do (JAX `ops/mega.py:710-717`), in calls of at most MAX_PLANES planes
    over the same offs."""
    trace = lambda *a, **kw: mega_trace(*a, geom, ts, trt, counts=counts, with_aux=with_aux,
                                        **kw)
    flat_aux = lambda aux: [c for pos, att in aux for c in (*pos, att)] if with_aux else []
    split = _split_plan(pix.shape[0], depth)
    if not split:
        rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx, aux = trace(
            o, d, pix, samp, seed, depth=depth
        )
        return rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx, flat_aux(aux)

    (rad_a, d_a, thru_a, missed_a, first_n, first_t, hit_a, aux_a, o_a) = trace(
        o, d, pix, samp, seed, depth=split, with_o=True
    )
    packed, offs, n_alive = stream_compact(
        missed_a, [pix, samp, *o_a, *d_a, *thru_a, missed_a]
    )
    # phase B: bounces [split, depth) of the packed lanes (pix, samp, o3, d3,
    # thru3, alive mask), its outputs as planes (rad3, miss_dir3, miss_thru3,
    # missed, hits, aux)
    nb = depth - split
    out = trace(tuple(packed[2:5]), tuple(packed[5:8]), packed[0], packed[1], seed, depth=nb,
                start_bounce=split, thru=tuple(packed[8:11]), n_alive=n_alive,
                alive_mask=packed[11])
    planes = [*out[0], *out[1], *out[2], out[3], *out[6], *flat_aux(out[7])]
    # back to their lanes, misses filled with 0.0 and hit planes with -1
    fills = [0.0] * 10 + [-1] * nb + [0.0] * (len(planes) - 10 - nb)
    back = []
    for k in range(0, len(planes), MAX_PLANES):
        back += stream_expand(missed_a, offs, planes[k:k + MAX_PLANES], fills[k:k + MAX_PLANES])
    a_dead = missed_a > 0.0
    rad = tuple(rad_a[k] + back[k] for k in range(3))
    miss_dir = tuple(torch.where(a_dead, d_a[k], back[3 + k]) for k in range(3))
    miss_thru = tuple(torch.where(a_dead, thru_a[k], back[6 + k]) for k in range(3))
    missed = missed_a + back[9]
    hit_idx = tuple(hit_a) + tuple(back[10:10 + nb])
    return (rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx,
            flat_aux(aux_a) + back[10 + nb:])


class MegaSample(torch.autograd.Function):
    """One megakernel sample as a differentiable function of the primary
    rays (o, d) and the record tables (ts, trt).

    Outputs: rad vec3, miss_dir vec3, miss_thru vec3, missed, first_n vec3,
    first_t (14 f32[R]), the winner planes i32[depth, R] and, with
    `with_aux`, 4 * depth aux planes f32[R] (pos vec3, att per bounce);
    missed and the winner planes carry no gradient.  The backward returns
    the cotangents of o, d, ts and trt through :func:`mega_bwd`, with the
    aux planes' cotangents for `with_aux` (see the module's docstring).
    """

    @staticmethod
    def forward(ctx, ox, oy, oz, dx, dy, dz, ts, trt, pix, samp, seed, depth, geom, counts,
                with_aux):
        o = (ox.contiguous(), oy.contiguous(), oz.contiguous())
        d = (dx.contiguous(), dy.contiguous(), dz.contiguous())
        rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx, aux = _trace(
            o, d, pix, samp, seed, depth, geom, ts, trt, counts, with_aux
        )
        hits = torch.stack(hit_idx)
        ctx.mark_non_differentiable(missed, hits)
        ctx.save_for_backward(*o, *d, pix, samp, ts, trt, hits)
        ctx.seed, ctx.with_aux = seed, with_aux
        return (*rad, *miss_dir, *miss_thru, missed, *first_n, first_t, hits, *aux)

    @staticmethod
    def backward(ctx, *ct):
        ox, oy, oz, dx, dy, dz, pix, samp, ts, trt, hits = ctx.saved_tensors
        cts = [c.contiguous() for c in ct[:9] + ct[10:14]]  # missed has none
        ct_aux = torch.stack(ct[15:]) if ctx.with_aux else None
        ct_ts, ct_trt, ct_o, ct_d = mega_bwd((ox, oy, oz), (dx, dy, dz), pix, samp, ctx.seed, ts,
                                             trt, hits, cts, ct_aux=ct_aux)
        return (*ct_o, *ct_d, ct_ts, ct_trt) + (None,) * 7


def mega_sample(gs, camera, pixel_idx, sample_idx, seed, depth, with_aux=False):
    """One sample for flat pixel indices i32[R] at sample `sample_idx`
    (int or i32[R]).

    Returns planar (rad vec3, miss_dir vec3, miss_thru vec3, missed
    f32[R], first_n vec3, first_t f32[R], hit_idx: depth i32[R] planes),
    plus with `with_aux` the per-bounce (pos vec3, att f32[R]) that the
    textured-albedo epilogue reads (pos and att carry gradients); the sky
    epilogue is the caller's.  Differentiable w.r.t. the grouped scene's
    tables and the camera: ray generation and the table build stay
    outside the autograd Function, so their gradients are autograd's.
    """
    r = pixel_idx.shape[0]
    dev = pixel_idx.device
    samp = sample_key(sample_idx, r, dev)
    pix = pixel_idx.to(torch.int32).contiguous()
    o, d = camera.ray_gen_planar(pix, samp, seed)
    with torch.no_grad():
        geom = build_geom_rows(gs)
    ts, trt = build_tables_T(gs)
    out = MegaSample.apply(*o, *d, ts, trt, pix, samp, seed, depth, geom, tuple(gs.counts),
                           with_aux)
    res = (out[0:3], out[3:6], out[6:9], out[9], out[10:13], out[13],
           tuple(out[14].unbind(0)))
    if with_aux:
        res = res + (tuple((tuple(out[15 + 4 * b:18 + 4 * b]), out[18 + 4 * b])
                           for b in range(depth)),)
    return res
