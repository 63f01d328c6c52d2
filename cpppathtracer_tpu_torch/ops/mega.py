"""One integrator sample through the megakernel, forward only.

Counterpart of the forward half of ``cpppathtracer_tpu/ops/mega.py``
(`mega_sample` / `_kernel_forward`).  The backward replay is not ported
yet, so nothing here is differentiable.

Survivor split: on the demo scene only about a fifth of the rays survive
bounce 1, and the survivors are scattered over the pixels, so the trace
runs bounces [0, 2) on every ray (phase A), packs the survivors to a dense
prefix (stream_compact), runs the later bounces on the packed domain
(phase B, whose threads past n_alive exit at once) and routes phase B's
outputs back to their pixels (stream_expand).  RNG keys are per (pixel,
sample, bounce), so the traced paths are bitwise those of the unsplit
trace; radiance differs only in the order of its float32 sum.
"""

from __future__ import annotations

import torch

from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import stream_compact, stream_expand
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T, mega_trace

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


def mega_sample(gs, camera, pixel_idx, sample_idx, seed, depth):
    """One sample for flat pixel indices i32[R] at sample `sample_idx`
    (int or i32[R]).

    Returns planar (rad vec3, miss_dir vec3, miss_thru vec3, missed
    f32[R], first_n vec3, first_t f32[R], hit_idx: depth i32[R] planes);
    the sky epilogue is the caller's.
    """
    r = pixel_idx.shape[0]
    dev = pixel_idx.device
    samp = torch.as_tensor(sample_idx, dtype=torch.int32, device=dev).expand(r).contiguous()
    pix = pixel_idx.to(torch.int32).contiguous()
    o, d = camera.ray_gen_planar(pix, samp, seed)
    o = tuple(c.contiguous() for c in o)
    d = tuple(c.contiguous() for c in d)
    geom = build_geom_rows(gs)
    ts, trt = build_tables_T(gs)
    trace = lambda *a, **kw: mega_trace(*a, geom, ts, trt, counts=gs.counts, **kw)

    split = _split_plan(r, depth)
    if not split:
        rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx, _ = trace(
            o, d, pix, samp, seed, depth=depth
        )
        return rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx

    (rad_a, d_a, thru_a, missed_a, first_n, first_t, hit_a, _, o_a) = trace(
        o, d, pix, samp, seed, depth=split, with_o=True
    )
    packed, pos, n_alive = stream_compact(
        missed_a,
        [pix, samp, *o_a, *d_a, *thru_a, missed_a],
        [-1, -1] + [0.0] * 9 + [1.0],
    )
    nb = depth - split
    rad_b, md_b, mt_b, missed_b, _, _, hit_b, _ = trace(
        tuple(packed[2:5]), tuple(packed[5:8]), packed[0], packed[1], seed,
        depth=nb, start_bounce=split, thru=tuple(packed[8:11]),
        n_alive=n_alive, alive_mask=packed[11],
    )
    back = stream_expand(
        missed_a, pos, [*rad_b, *md_b, *mt_b, missed_b, *hit_b],
        [0.0] * 10 + [-1] * nb, n_alive,
    )
    a_dead = missed_a > 0.0
    rad = tuple(rad_a[k] + back[k] for k in range(3))
    miss_dir = tuple(torch.where(a_dead, d_a[k], back[3 + k]) for k in range(3))
    miss_thru = tuple(torch.where(a_dead, thru_a[k], back[6 + k]) for k in range(3))
    missed = missed_a + back[9]
    hit_idx = tuple(hit_a) + tuple(back[10:])
    return rad, miss_dir, miss_thru, missed, first_n, first_t, hit_idx
