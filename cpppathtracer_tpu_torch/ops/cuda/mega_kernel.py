"""The bounce-loop megakernel: wrapper, tables and plain PyTorch version.

Counterpart of ``cpppathtracer_tpu/ops/pallas/mega_kernel.py``.  The CUDA
kernel is ``csrc/mega_trace.cu``; :func:`mega_trace_plain` is the same
function in plain PyTorch, which the CPU runs and against which the kernel
is held on the card.

Semantics (`integrator.trace_bounces`' planar body, `cuSrc/path_tracer.cu:
124-175`): per bounce, the closest hit (none where the search finds no
object), its record, hit attributes, PCG4D uniforms keyed (seed, pixel,
sample, 1 + bounce) and BSDF sampling;
radiance gathers thru * emitted on live hits, thru takes the attenuation,
a miss ends the path, and the next ray starts at the hit with the sampled
direction and tmin = BOUNCE_RAY_TMIN.  The sky epilogue is the caller's.
The `with_aux` form also returns, per bounce, the hit position and the
attenuation-on mask (glass, or dot(normal, bounce_dir) > 0) that the
textured-albedo epilogue (``integrator._mega_tex_radiance``) reads.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cpppathtracer_tpu_torch.ops import planar
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import ceil8, winner_t_index_plain
from cpppathtracer_tpu_torch.types import INF, TMIN_BOUNCE, MaterialType
from cpppathtracer_tpu_torch.utils.rng import seed_word, uniforms4


def build_tables_T(gs):
    """Transposed record tables for the in-kernel fetch: (table_s^T
    f32[13, n_pad], table_r^T f32[4, n_pad]), n_pad = max(8, ceil8(Na));
    pad columns are zero and never win (winners are < Na)."""
    na = sum(gs.counts)
    n_pad = max(8, ceil8(na))
    pad = lambda t: torch.nn.functional.pad(t[:na].T, (0, n_pad - na)).contiguous()
    return pad(gs.table_s), pad(gs.table_r)


def mega_smem_bytes(n_rep: int, n_pad: int) -> int:
    """Shared memory one block of ``csrc/mega_trace.cu`` stages: the
    geometry rows f32[n_rep, 8] and both record tables f32[13 + 4, n_pad]."""
    return 4 * (8 * n_rep + 17 * n_pad)


def check_mega_smem(n_rep: int, n_pad: int, limit: int):
    """Raise ValueError when a scene's rows and tables exceed `limit`
    bytes of shared memory per block."""
    need = mega_smem_bytes(n_rep, n_pad)
    if need > limit:
        raise ValueError(
            f"mega_trace stages {n_rep} geometry rows and {n_pad} table columns "
            f"({need} bytes) in shared memory; one block of this card holds at most "
            f"{limit} bytes: give the scene BVH tables (build(bvh=True)), or leave "
            f"POCA_BVH unset so that they are used"
        )


def launch_counts(gs, r: int, with_aux: bool = False) -> dict:
    """The launch shape of ``csrc/mega_trace.cu`` on the grouped scene `gs`
    over R lanes, on the current card, as the serving span counts it: the
    bytes one block stages in shared memory (`mega_smem_bytes`) and the
    blocks resident on an SM (`mega_blocks_sm`, ``poca_mega_info``)."""
    n_s, n_p, n_c = gs.counts
    n_rep = max(8, ceil8(n_s) + ceil8(n_p) + ceil8(n_c))  # build_geom_rows' rows
    n_pad = max(8, ceil8(n_s + n_p + n_c))  # build_tables_T's columns
    info = (ctypes.c_int * 4)()
    kb.check(kb.library().poca_mega_info(int(with_aux), r, n_rep, n_pad, ctypes.addressof(info)),
             "poca_mega_info")
    return {"mega_smem_bytes": mega_smem_bytes(n_rep, n_pad), "mega_blocks_sm": info[2]}


@functools.cache
def _smem_optin(index: int) -> int:
    out = ctypes.c_int(0)
    kb.check(kb.library().poca_smem_optin(index, ctypes.addressof(out)), "poca_smem_optin")
    return out.value


def _outputs(out_f, out_o, hits, depth, with_o, aux=None):
    rad = tuple(out_f[0:3])
    miss_dir = tuple(out_f[3:6])
    miss_thru = tuple(out_f[6:9])
    if aux is not None:
        aux = tuple((tuple(aux[4 * b:4 * b + 3]), aux[4 * b + 3]) for b in range(depth))
    out = (rad, miss_dir, miss_thru, out_f[9], tuple(out_f[10:13]), out_f[13],
           tuple(hits[b] for b in range(depth)), aux)
    if with_o:
        out = out + (tuple(out_o),)
    return out


def mega_trace(o, d, pixel_idx, sample_idx, seed, geom, ts, trt, *, counts, depth,
               start_bounce=0, with_o=False, thru=None, n_alive=None,
               alive_mask=None, with_aux=False, stats=None):
    """Run `depth` bounces for planar rays (o, d: tuples of f32[R]).

    pixel_idx, sample_idx i32[R]; seed an int or an i32 tensor of one
    element on the rays' device (the kernel reads it there, as the Pallas
    kernel reads its scalar-prefetch seed, so a captured launch replays
    any seed written into it); geom f32[N_rep, 8]
    (build_geom_rows); ts, trt from :func:`build_tables_T`.  Phase B of
    the split trace passes `start_bounce`, an input `thru`, `n_alive`
    (i32[1] on the device) and `alive_mask` (f32[R], nonzero = dead):
    lanes at or past n_alive, or masked, publish neutral outputs (zeros,
    hit -1).

    Returns (rad vec3, miss_dir vec3, miss_thru vec3, missed f32[R],
    first_n vec3, first_t f32[R], hit_idx: depth i32[R] planes, aux),
    plus the final origin vec3 when `with_o`.  A hit plane holds the
    winner's dense grouped index on a hit and -1 on a miss.  aux is None,
    or with `with_aux` a tuple of depth (pos vec3, att f32[R]): the
    bounce's hit position (the ray's origin on a miss) and its
    attenuation-on mask, 1.0 or 0.0; zeros on inactive lanes.

    CUDA tensors launch ``csrc/mega_trace.cu``; CPU tensors take
    :func:`mega_trace_plain`.  A scene whose rows and tables exceed the
    card's shared memory per block raises ValueError.  `stats`, an int64
    tensor of 2 on the card, has the launch add the lane searches it ran
    for a ray and the warp lane slots its searches took (a measurement,
    ``chip_smoke.py``); the CPU ignores it.
    """
    if alive_mask is not None and n_alive is None:
        raise ValueError("alive_mask needs n_alive")
    dev = pixel_idx.device
    if dev.type == "cpu":
        return mega_trace_plain(
            o, d, pixel_idx, sample_idx, seed, geom, ts, trt, counts=counts,
            depth=depth, start_bounce=start_bounce, with_o=with_o, thru=thru,
            n_alive=n_alive, alive_mask=alive_mask, with_aux=with_aux,
        )
    if dev.type != "cuda":
        raise ValueError(f"mega_trace runs on cuda or cpu tensors, got {dev}")

    r = pixel_idx.shape[0]
    n_s, n_p, n_c = counts
    f32, i32 = torch.float32, torch.int32
    planes = list(o) + list(d) + (list(thru) if thru is not None else [])
    for k, t in enumerate(planes):
        kb.require(t, f"ray plane {k}", f32, (r,), dev)
    kb.require(pixel_idx, "pixel_idx", i32, (r,), dev)
    kb.require(sample_idx, "sample_idx", i32, (r,), dev)
    kb.require(geom, "geom", f32, (geom.shape[0], 8), dev)
    n_pad = ts.shape[1]
    kb.require(ts, "ts", f32, (13, n_pad), dev)
    kb.require(trt, "trt", f32, (4, n_pad), dev)
    if geom.shape[0] < ceil8(n_s) + ceil8(n_p) + ceil8(n_c) or n_pad < n_s + n_p + n_c:
        raise ValueError("scene tables are smaller than the counts")
    check_mega_smem(geom.shape[0], n_pad, _smem_optin(dev.index if dev.index is not None
                                                      else torch.cuda.current_device()))
    if n_alive is not None:
        kb.require(n_alive, "n_alive", i32, (1,), dev)
    if alive_mask is not None:
        kb.require(alive_mask, "alive_mask", f32, (r,), dev)
    if stats is not None:
        kb.require(stats, "stats", torch.int64, (2,), dev)
    seed_w = seed_word(seed, dev)

    out_f = torch.empty((14, r), dtype=f32, device=dev)
    out_o = torch.empty((3, r), dtype=f32, device=dev) if with_o else None
    hits_buf = torch.empty((depth * r + 1,), dtype=i32, device=dev)  # word depth * r: the ray counter
    hits = hits_buf[:depth * r].view(depth, r)
    counter = hits_buf.data_ptr() + 4 * depth * r
    aux = torch.empty((4 * depth, r), dtype=f32, device=dev) if with_aux else None
    thru_p = [kb.ptr(t) for t in thru] if thru is not None else [None] * 3
    with torch.cuda.device(dev):
        err = kb.library().poca_mega_trace(
            *[t.data_ptr() for t in o], *[t.data_ptr() for t in d], *thru_p,
            pixel_idx.data_ptr(), sample_idx.data_ptr(),
            geom.data_ptr(), ts.data_ptr(), trt.data_ptr(),
            kb.ptr(n_alive), kb.ptr(alive_mask),
            out_f.data_ptr(), kb.ptr(out_o), hits.data_ptr(), kb.ptr(aux),
            counter, kb.ptr(stats), seed_w.data_ptr(),
            r, n_s, n_p, n_c, geom.shape[0], n_pad, depth, start_bounce,
            kb.stream_handle(pixel_idx),
        )
    kb.check(err, "mega_trace")
    kb.LAUNCHES["mega_trace_aux" if with_aux else "mega_trace"] += 1
    return _outputs(out_f, out_o, hits, depth, with_o, aux)


def mega_trace_plain(o, d, pixel_idx, sample_idx, seed, geom, ts, trt, *, counts,
                     depth, start_bounce=0, with_o=False, thru=None, n_alive=None,
                     alive_mask=None, with_aux=False):
    """Plain PyTorch version of :func:`mega_trace` (same arguments but
    `stats`, same outputs), on any device.  It runs every bounce of
    every lane, as the JAX package's loop does; the kernel ends a path at
    its first miss, which gives the same outputs (``csrc/mega_trace.cu``)."""
    r = pixel_idx.shape[0]
    dev = pixel_idx.device
    zero = torch.zeros((r,), dtype=torch.float32, device=dev)
    one = zero + 1.0
    active = zero < 1.0
    if n_alive is not None:
        active = torch.arange(r, device=dev) < n_alive
        if alive_mask is not None:
            active = active & (alive_mask == 0.0)
    thru = (one, one, one) if thru is None else tuple(thru)
    rad = (zero, zero, zero)
    first_n = (zero, zero, zero)
    first_t = zero
    alive = active
    tmax = zero + INF
    table_s, table_r = ts.T, trt.T
    hits, aux = [], []
    for b in range(depth):
        tmin = zero + (0.0 if start_bounce + b == 0 else TMIN_BOUNCE)
        best_t, best_i = winner_t_index_plain(counts, o, d, tmin, tmax, geom)
        # a search that found no object is a miss: the recompute's window closes there
        window = torch.where(best_t < INF, tmax, tmin)
        hitrec, mats = planar.gather_epilogue_p(table_s, table_r, o, d, tmin, window, best_i)
        hit = hitrec["hit"]
        hits.append(torch.where(hit, best_i, torch.full_like(best_i, -1)))
        u1, u2, u3, _ = uniforms4(seed, pixel_idx, sample_idx, 1 + start_bounce + b)
        bounce_dir, attenuation, emitted = planar.shade_p(
            mats, hitrec["normal"], d, u1, u2, u3, score_grad=False
        )
        if with_aux:
            att_on = (mats["mat_type"] == MaterialType.GLASS) | (
                planar.dot_p(hitrec["normal"], bounce_dir) > 0.0
            )
            aux += [*hitrec["pos"], att_on.to(torch.float32)]
        live_hit = hit & alive
        lh = live_hit.to(torch.float32)
        rad = planar.add_p(rad, planar.scale_p(planar.mul_p(thru, emitted), lh))
        thru = planar.where_p(live_hit, planar.mul_p(thru, attenuation), thru)
        if b == 0:
            first_n = planar.where_p(hit, hitrec["normal"], planar.scale_p(d, -1.0))
            first_t = hitrec["t"]
        alive = alive & hit
        o = planar.where_p(hit, hitrec["pos"], o)
        d = planar.where_p(hit, planar.normalize_p(bounce_dir), d)

    missed = (active & ~alive).to(torch.float32)
    out_f = torch.stack(list(rad) + list(d) + list(thru) + [missed] + list(first_n) + [first_t])
    out_f = torch.where(active, out_f, zero)
    out_o = torch.where(active, torch.stack(o), zero) if with_o else None
    hit_st = torch.where(active, torch.stack(hits), torch.full_like(hits[0], -1))
    aux_st = torch.where(active, torch.stack(aux), zero) if with_aux else None
    return _outputs(out_f, out_o, hit_st, depth, with_o, aux_st)
