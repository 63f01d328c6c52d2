"""One integrator sample through the megakernel, differentiable.

Counterpart of ``cpppathtracer_tpu/ops/mega.py``: `mega_sample` (its
`custom_vjp`), `_kernel_forward`, and the replay `_replay_chain` /
`_replay_outputs` that defines the backward.

Forward, survivor split: on the demo scene only about a fifth of the rays
survive bounce 1, and the survivors are scattered over the pixels, so the
trace runs bounces [0, 2) on every ray (phase A), packs the survivors to a
dense prefix (stream_compact; its lanes past n_alive are unspecified and
never read), runs the later bounces on the packed domain (phase B, whose
threads past n_alive exit at once) and routes phase B's outputs back to
their pixels (stream_expand, through the compaction's per-block offsets).
RNG keys are per (pixel, sample, bounce), so the traced paths are bitwise
those of the unsplit trace; radiance differs only in the order of its
float32 sum.

Backward: the forward saves only the primary rays, the record tables and
the per-bounce winner planes (i32[depth, R], the winner's grouped index on
a hit, -1 on a miss).  The replay rebuilds every bounce from the saved
winner, with no winner search, and its gradient is the sample's gradient.
On the card the hand-written kernel ``csrc/mega_bwd.cu`` computes it; on
the CPU, torch autograd of :func:`_replay_outputs`.  The JAX package's
split replay, 16-bit residual packing and layout firewall are TPU memory
and layout devices and are not ported.
"""

from __future__ import annotations

import torch

from cpppathtracer_tpu_torch.ops import planar
from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import stream_compact, stream_expand
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T, mega_trace
from cpppathtracer_tpu_torch.types import INF, TMIN_BOUNCE
from cpppathtracer_tpu_torch.utils.rng import uniforms4

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
    JAX package's rule (`ops/mega.py:329-348`), which splits at bounce 2
    when phase B has at least two bounces and R spans at least four
    megakernel tiles."""
    tile = min(_MEGA_TILE, _pick_tile(r))
    r_pad = -(-r // tile) * tile
    return _SPLIT if depth - _SPLIT >= 2 and r_pad >= 4 * tile else 0


# ------------------------------------------------------------------ replay


def _replay_chain(ts, trt, o, d, thru, rad, alive, hit_planes, pixel_idx, sample_idx, seed):
    """Bounces [0, len(hit_planes)) rebuilt from the saved winner planes
    (the JAX package's `_replay_chain` from bounce 0: its later start
    serves only the split replay, which is not ported).

    The hit attributes are recomputed from the saved winner, so geometry
    gradients flow through t and the normal, but the saved sign alone
    decides whether the bounce hit (`hit = enc >= 0`): the value being
    differentiated is the one the kernel's chain produced
    (`tests/test_mega.py:260`).  Returns the carry (o, d, thru, rad, alive)
    and the first-bounce records (first_n, first_t).
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
    for b, enc in enumerate(hit_planes):
        tmin = zero + (0.0 if b == 0 else TMIN_BOUNCE)
        hitrec, mats = planar.gather_epilogue_p(
            table_s, table_r, o, d, tmin, tmax, torch.clamp(enc, min=0)
        )
        hit = enc >= 0
        u1, u2, u3, _ = uniforms4(seed, pixel_idx, sample_idx, 1 + b)
        bounce_dir, attenuation, emitted, _ = planar.shade_p(
            mats, hitrec["normal"], d, u1, u2, u3, with_score=True
        )
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
    return o, d, thru, rad, alive, first_n, first_t


def _replay_outputs(o, d, ts, trt, pixel_idx, sample_idx, seed, hit_planes):
    """The megakernel's outputs rebuilt from the primary rays (o, d) and the
    saved winner planes: (rad, miss_dir, miss_thru, missed, first_n,
    first_t), plus the final origin, as `mega_trace` returns them."""
    zero = torch.zeros_like(o[0])
    one = zero + 1.0
    o, d, thru, rad, alive, first_n, first_t = _replay_chain(
        ts, trt, o, d, (one, one, one), (zero, zero, zero), zero < 1.0, hit_planes,
        pixel_idx, sample_idx, seed,
    )
    missed = (~alive).to(torch.float32)
    return rad, d, thru, missed, first_n, first_t, o


# ---------------------------------------------------------------- forward


def _trace(o, d, pix, samp, seed, depth, geom, ts, trt, counts):
    """The megakernel's forward of one sample, split where `_split_plan`
    says.  Returns (rad, miss_dir, miss_thru, missed, first_n, first_t,
    hit planes)."""
    trace = lambda *a, **kw: mega_trace(*a, geom, ts, trt, counts=counts, **kw)
    split = _split_plan(pix.shape[0], depth)
    if not split:
        rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx, _ = trace(
            o, d, pix, samp, seed, depth=depth
        )
        return rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx

    (rad_a, d_a, thru_a, missed_a, first_n, first_t, hit_a, _, o_a) = trace(
        o, d, pix, samp, seed, depth=split, with_o=True
    )
    packed, offs, n_alive = stream_compact(
        missed_a, [pix, samp, *o_a, *d_a, *thru_a, missed_a]
    )
    nb = depth - split
    rad_b, md_b, mt_b, missed_b, _, _, hit_b, _ = trace(
        tuple(packed[2:5]), tuple(packed[5:8]), packed[0], packed[1], seed,
        depth=nb, start_bounce=split, thru=tuple(packed[8:11]),
        n_alive=n_alive, alive_mask=packed[11],
    )
    back = stream_expand(
        missed_a, offs, [*rad_b, *md_b, *mt_b, missed_b, *hit_b], [0.0] * 10 + [-1] * nb
    )
    a_dead = missed_a > 0.0
    rad = tuple(rad_a[k] + back[k] for k in range(3))
    miss_dir = tuple(torch.where(a_dead, d_a[k], back[3 + k]) for k in range(3))
    miss_thru = tuple(torch.where(a_dead, thru_a[k], back[6 + k]) for k in range(3))
    missed = missed_a + back[9]
    hit_idx = tuple(hit_a) + tuple(back[10:])
    return rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx


class MegaSample(torch.autograd.Function):
    """One megakernel sample as a differentiable function of the primary
    rays (o, d) and the record tables (ts, trt).

    Outputs: rad vec3, miss_dir vec3, miss_thru vec3, missed, first_n vec3,
    first_t (14 f32[R]) and the winner planes i32[depth, R]; missed and
    the planes carry no gradient.  The backward returns the cotangents of
    o, d, ts and trt through :func:`mega_bwd`.
    """

    @staticmethod
    def forward(ctx, ox, oy, oz, dx, dy, dz, ts, trt, pix, samp, seed, depth, geom, counts):
        o = (ox.contiguous(), oy.contiguous(), oz.contiguous())
        d = (dx.contiguous(), dy.contiguous(), dz.contiguous())
        rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx = _trace(
            o, d, pix, samp, seed, depth, geom, ts, trt, counts
        )
        hits = torch.stack(hit_idx)
        ctx.mark_non_differentiable(missed, hits)
        ctx.save_for_backward(*o, *d, pix, samp, ts, trt, hits)
        ctx.seed = seed
        return (*rad, *miss_dir, *miss_thru, missed, *first_n, first_t, hits)

    @staticmethod
    def backward(ctx, *ct):
        ox, oy, oz, dx, dy, dz, pix, samp, ts, trt, hits = ctx.saved_tensors
        cts = [c.contiguous() for c in ct[:9] + ct[10:14]]  # missed has none
        ct_ts, ct_trt, ct_o, ct_d = mega_bwd(
            (ox, oy, oz), (dx, dy, dz), pix, samp, ctx.seed, ts, trt, hits, cts
        )
        return (*ct_o, *ct_d, ct_ts, ct_trt) + (None,) * 6


def mega_sample(gs, camera, pixel_idx, sample_idx, seed, depth):
    """One sample for flat pixel indices i32[R] at sample `sample_idx`
    (int or i32[R]).

    Returns planar (rad vec3, miss_dir vec3, miss_thru vec3, missed
    f32[R], first_n vec3, first_t f32[R], hit_idx: depth i32[R] planes);
    the sky epilogue is the caller's.  Differentiable w.r.t. the grouped
    scene's tables and the camera: ray generation and the table build stay
    outside the autograd Function, so their gradients are autograd's.
    """
    r = pixel_idx.shape[0]
    dev = pixel_idx.device
    samp = torch.as_tensor(sample_idx, dtype=torch.int32, device=dev).expand(r).contiguous()
    pix = pixel_idx.to(torch.int32).contiguous()
    o, d = camera.ray_gen_planar(pix, samp, seed)
    with torch.no_grad():
        geom = build_geom_rows(gs)
    ts, trt = build_tables_T(gs)
    out = MegaSample.apply(*o, *d, ts, trt, pix, samp, seed, depth, geom, tuple(gs.counts))
    return (out[0:3], out[3:6], out[6:9], out[9], out[10:13], out[13],
            tuple(out[14].unbind(0)))
