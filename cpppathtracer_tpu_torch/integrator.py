"""Monte-Carlo radiance over many samples (counterpart of
``cpppathtracer_tpu/integrator.py``): the megakernel path and the
per-bounce wavefront path.

Loop semantics of the reference (`cuSrc/path_tracer.cu:141-170`), on both
paths: per bounce the closest hit, its record, PCG4D uniforms and BSDF
sampling; radiance gathers thru * emitted on live hits, thru takes the
attenuation, a miss ends the path, the next ray starts at the hit with
tmin = BOUNCE_RAY_TMIN.  Each sample adds the sky seen by the escaped
paths, sampled once per path at its miss direction and throughput.  The
first-hit normal and t of sample 0 feed the denoiser
(`path_tracer.cu:159-163`; t in place of the reference's constant depth
buffer, as the JAX package does).

Which path a render takes is the JAX package's rule
(`integrator.py:72-75, 416-424`): a dense grouped scene takes the
megakernel (``ops/mega.py``); a scene with BVH tables, or any grouped
scene under POCA_MEGA=0, takes the per-bounce wavefront path, whose
closest hit walks the BVH (``csrc/bvh.cu``) or runs the dense winner
kernel (``csrc/winner.cu``); POCA_BVH=0 ignores attached tables.  The
wavefront path runs the planar body for flat pixel indices, whose work
around the winner search is one ``csrc/wavefront.cu`` launch a bounce on
the card when nothing needs its graph (:func:`trace_bounces`); under
POCA_PLANAR=0 it runs the row-major body (:func:`trace_bounces_rowmajor`,
JAX `integrator.py:142-192`), whose closest hit is
``fast.intersect_and_gather`` (the dense winner kernel once a bounce on
the card, BVH tables or not).  A scene without type metadata
(``fast.group_scene`` gives None) always takes the row-major body, with
the dense ``intersect.intersect`` and ``bsdf.gather_materials`` and no
kernel, for pixel indices of any shape; a grouped scene renders only
flat pixel indices, as in the JAX package.

Textured albedo (`tex_stack`, f32[T, H, W, 3]; an object's tex_id picks
its texture, -1 none): the wavefront bounce samples the texture at the
hit's UV (``ops/uv.py``) and it replaces kd in the attenuation; the
megakernel path takes the kernel's `with_aux` form and replays the
radiance recurrence with the textured albedo in
:func:`_mega_tex_radiance` (JAX `integrator.py:271-333`).

Every path is differentiable.  The megakernel's backward is
``ops/mega.py::MegaSample``.  The planar wavefront body's is
:class:`WavefrontSample`: its forward saves each bounce's winner index,
and its backward replays the bounces from them without the winner search
(JAX `integrator.py:194-225, 481-486`).  The row-major body's is plain
autograd: its winner indices are selected without a graph.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from cpppathtracer_tpu_torch.ops import bsdf, fast, intersect, mathx, planar, texture
from cpppathtracer_tpu_torch.ops.cuda import mega_kernel
from cpppathtracer_tpu_torch.ops.cuda.wavefront_kernel import (
    bounce_p,
    carry_parts,
    field_major_tables,
    start_planes,
    wavefront_bounce,
)
from cpppathtracer_tpu_torch.ops.mathx import div_const
from cpppathtracer_tpu_torch.ops.mega import mega_sample
from cpppathtracer_tpu_torch.ops.uv import surface_uv, surface_uv_p
from cpppathtracer_tpu_torch.types import INF, TMIN_BOUNCE, Rays
from cpppathtracer_tpu_torch.utils import obs
from cpppathtracer_tpu_torch.utils.graphs import (
    Entry,
    GraphedCall,
    copy_into,
    env_switches,
    requires_grad,
    signature,
    static_twin,
)
from cpppathtracer_tpu_torch.utils.rng import sample_key, uniforms4, write_seed


def _textured_kd(tex_id, geom_p, pos, tex_stack, kd):
    """The attenuation's albedo: texture tex_id[i] of the stack sampled at
    the UV of pos on the object (geom_p = prim_type, center, radius, y_pos,
    height), or kd where tex_id < 0 (`Material::GetKd`,
    `material.cu:11-18`).  A static loop over the stack, as in the JAX
    package."""
    uu, vv = surface_uv_p(*geom_p, pos)
    zero = torch.zeros_like(uu)
    kd_tex = (zero, zero, zero)
    for t in range(tex_stack.shape[0]):
        smp = planar.unstack_v3(texture.sample_bilinear(tex_stack[t], uu, vv))
        kd_tex = planar.where_p(tex_id == t, smp, kd_tex)
    return planar.where_p(tex_id >= 0, kd_tex, kd)


def trace_bounces(gs, rays, pixel_idx, sample_idx, seed, max_depth: int, *, tex_stack=None,
                  gidx_planes=None, tables=None):
    """Integrate `max_depth` bounces of planar primary rays (`rays` = (o, d),
    tuples of f32[R]) over the grouped scene `gs` one bounce at a time.
    Each bounce's winner is ``fast.closest_index`` (the BVH walk or the
    dense search), or with `gidx_planes` the saved one; its record and hit
    attributes come from `tables` (default gs.table_s, gs.table_r), and the
    hit is recomputed from them (t < INF).  With both `gidx_planes` and
    `tables`, `gs` is not read.  With `tex_stack` the attenuation takes the
    textured albedo.  A path that missed keeps its ray, which misses again,
    so at the end its direction and throughput are the miss direction and
    throughput.

    The body around the winner search is one ``csrc/wavefront.cu`` launch a
    bounce where the call allows it: CUDA tensors, grad mode off, no saved
    winners and no textures (the serving path and
    :class:`WavefrontSample`'s forward).  Everywhere else it is the PyTorch
    body, :func:`trace_bounces_p`.  Both give the same bits.

    Returns planar (rad vec3, miss_dir vec3, miss_thru vec3, missed f32[R],
    first_n vec3, first_t f32[R], winner index planes, hit planes (bool;
    None where the kernel ran, which keeps none)); the sky epilogue is the
    caller's (:func:`sky_epilogue`)."""
    if (rays[0][0].is_cuda and not torch.is_grad_enabled() and gidx_planes is None
            and tex_stack is None):
        return _trace_fused(gs, rays, pixel_idx, sample_idx, seed, max_depth, tables)
    return trace_bounces_p(gs, rays, pixel_idx, sample_idx, seed, max_depth,
                           tex_stack=tex_stack, gidx_planes=gidx_planes, tables=tables)


def trace_bounces_p(gs, rays, pixel_idx, sample_idx, seed, max_depth: int, *, tex_stack=None,
                    gidx_planes=None, tables=None):
    """:func:`trace_bounces` in PyTorch on any device: each bounce's winner,
    then ``wavefront_kernel.bounce_p``.  Differentiable."""
    table_s, table_r = (gs.table_s, gs.table_r) if tables is None else tables
    o, d = rays
    zero = torch.zeros_like(o[0])
    one = zero + 1.0
    carry = (o, d, (one, one, one), (zero, zero, zero), zero < 1.0)
    first_n, first_t = (zero, zero, zero), zero
    tmax = zero + INF
    kd_of = None
    if tex_stack is not None:
        kd_of = lambda mats, hit: _textured_kd(mats["tex_id"], mats["_geom_p"], hit["pos"],
                                               tex_stack, mats["kd_p"])
    gidxs, hits = [], []
    for b in range(max_depth):
        tmin = zero + (0.0 if b == 0 else TMIN_BOUNCE)
        gidx = (fast.closest_index(gs, carry[0], carry[1], tmin, tmax) if gidx_planes is None
                else gidx_planes[b])
        gidxs.append(gidx)
        carry, hit, first = bounce_p(table_s, table_r, carry, gidx, tmin, tmax, pixel_idx,
                                     sample_idx, seed, b, kd_of=kd_of)
        hits.append(hit)
        if first is not None:
            first_n, first_t = first
    _, d, thru, rad, alive = carry
    return rad, d, thru, (~alive).to(torch.float32), first_n, first_t, gidxs, hits


def _trace_fused(gs, rays, pixel_idx, sample_idx, seed, max_depth: int, tables=None):
    """:func:`trace_bounces` on the card without autograd: the winner
    search and one ``wavefront_bounce`` launch a bounce, on carry planes
    updated in place (so `o`, `d`, `thru`, `rad` below, views of them, hold
    each bounce's values).  From bounce 2 the BVH walk takes the live set
    (alive, first_t, the last winners): a lane that missed at a bounce >= 1
    keeps its ray, so it keeps its winner unwalked."""
    carry, alive, first = start_planes(*rays)
    o, d, thru, rad = carry_parts(carry)
    ts, trt = field_major_tables(*((gs.table_s, gs.table_r) if tables is None else tables))
    pix = pixel_idx.to(torch.int32).contiguous()
    samp = sample_key(sample_idx, pix.shape[0], pix.device)
    zero = torch.zeros_like(o[0])
    tmins = (zero, zero + TMIN_BOUNCE)
    tmax = zero + INF
    gidxs = []
    for b in range(max_depth):
        live = (alive, first[3], gidxs[-1]) if b >= 2 else None
        gidx = fast.closest_index(gs, o, d, tmins[b > 0], tmax, live=live)
        gidxs.append(gidx)
        wavefront_bounce(carry, alive, first, gidx, pix, samp, seed, ts, trt, bounce=b)
    return (rad, d, thru, (~alive).to(torch.float32), tuple(first[0:3]), first[3], gidxs,
            None)


class WavefrontSample(torch.autograd.Function):
    """One wavefront sample as a differentiable function of the primary
    rays (o, d), the record tables gs.table_s and gs.table_r and the
    texture stack.

    Outputs: rad vec3, miss_dir vec3, miss_thru vec3, missed, first_n
    vec3, first_t (14 f32[R]); missed carries no gradient.  The forward
    runs :func:`trace_bounces` and keeps only the inputs and each bounce's
    winner index (i32[depth, R]).  The backward runs it again with those
    indices under autograd, so neither the BVH walk nor the dense search
    runs twice; its records are gathered from float64 copies of the tables
    (the values unchanged), so that the table cotangents sum over the
    lanes in float64, as the megakernel's replay does.
    """

    @staticmethod
    def forward(ctx, ox, oy, oz, dx, dy, dz, table_s, table_r, tex_stack, gs, pix, samp, seed,
                depth):
        rad, md, mt, missed, first_n, first_t, gidxs, _ = trace_bounces(
            gs, ((ox, oy, oz), (dx, dy, dz)), pix, samp, seed, depth, tex_stack=tex_stack,
            tables=(table_s, table_r),
        )
        ctx.mark_non_differentiable(missed)
        ctx.save_for_backward(ox, oy, oz, dx, dy, dz, table_s, table_r, tex_stack, pix, samp,
                              torch.stack(gidxs))
        ctx.seed, ctx.depth = seed, depth
        return (*rad, *md, *mt, missed, *first_n, first_t)

    @staticmethod
    def backward(ctx, *ct):
        *inputs, pix, samp, gidx = ctx.saved_tensors
        xs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(inputs, ctx.needs_input_grad)]
        wrt = [x for x in xs if x is not None and x.requires_grad]
        grads = [None] * len(xs)
        with torch.enable_grad():
            rad, md, mt, _, first_n, first_t, _, _ = trace_bounces(
                None, (tuple(xs[0:3]), tuple(xs[3:6])), pix, samp, ctx.seed, ctx.depth,
                tex_stack=xs[8], gidx_planes=gidx.unbind(0),
                tables=(xs[6].double(), xs[7].double()),
            )
            outs = [*rad, *md, *mt, *first_n, first_t]
            pairs = [(y, c) for y, c in zip(outs, ct[:9] + ct[10:]) if y.requires_grad]
            if pairs:
                got = iter(torch.autograd.grad([y for y, _ in pairs], wrt,
                                               [c for _, c in pairs], allow_unused=True))
                grads = [next(got) if x is not None and x.requires_grad else None for x in xs]
        return (*grads, None, None, None, None, None)


def wavefront_sample(gs, camera, pixel_idx, sample_idx, seed, depth, tex_stack=None):
    """One sample of the wavefront path for flat pixel indices i32[R] at
    sample `sample_idx` (int or i32[R]): planar (rad vec3, miss_dir vec3,
    miss_thru vec3, missed f32[R], first_n vec3, first_t f32[R]), as
    ``ops/mega.py::mega_sample`` returns them.  Ray generation and the
    sky epilogue stay outside :class:`WavefrontSample`, so their gradients
    are autograd's.  When nothing requires grad (the serving path) the
    bounces run directly, with no Function and no saved winner planes."""
    r = pixel_idx.shape[0]
    dev = pixel_idx.device
    pix = pixel_idx.to(torch.int32)
    samp = sample_key(sample_idx, r, dev)
    o, d = camera.ray_gen_planar(pix, samp, seed)
    inputs = (*o, *d, gs.table_s, gs.table_r, tex_stack)
    if not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs)):
        with torch.no_grad():
            rad, md, mt, missed, first_n, first_t, _, _ = trace_bounces(
                gs, (o, d), pix, samp, seed, depth, tex_stack=tex_stack)
        return rad, md, mt, missed, first_n, first_t
    out = WavefrontSample.apply(*inputs, gs, pix, samp, seed, depth)
    return out[0:3], out[3:6], out[6:9], out[9], out[10:13], out[13]


def trace_bounces_rowmajor(scene, gs, rays, pixel_idx, sample_idx, seed, max_depth: int, *,
                           tex_stack=None):
    """Integrate `max_depth` bounces of row-major primary rays (`Rays` of
    any batch shape) one bounce at a time: the JAX package's
    `body_rowmajor` (`integrator.py:142-192`).  Each bounce's closest hit
    is ``fast.intersect_and_gather`` on the grouped scene `gs`, or, where
    `gs` is None, ``intersect.intersect`` and ``bsdf.gather_materials`` on
    `scene`.  Differentiable by autograd.

    Returns (radiance f32[..., 3] without the sky, miss direction and miss
    throughput f32[..., 3], missed bool[...], first_n f32[..., 3],
    first_t f32[...]); a path that missed keeps its ray, so at the end its
    direction and throughput are those it missed with."""
    batch = rays.tmin.shape
    origin, direction = rays.origin, rays.dir
    throughput = torch.ones_like(origin)
    radiance = torch.zeros_like(origin)
    first_n, first_t = torch.zeros_like(origin), torch.zeros_like(rays.tmin)
    alive = rays.tmax > 0.0
    tmax = torch.full(batch, INF, dtype=torch.float32, device=origin.device)
    for b in range(max_depth):
        cur = Rays(origin, direction, torch.full_like(tmax, 0.0 if b == 0 else TMIN_BOUNCE), tmax)
        if gs is not None:
            hit, mats = fast.intersect_and_gather(gs, cur)
        else:
            hit = intersect.intersect(scene, cur)
            mats = bsdf.gather_materials(scene, hit.obj_idx)
        u1, u2, u3, _ = uniforms4(seed, pixel_idx, sample_idx, 1 + b)
        kd_override = None
        if tex_stack is not None:
            tid = mats["tex_id"]
            u, v = surface_uv(*mats["_geom"], hit.pos)
            kd_tex = torch.zeros_like(mats["kd"])
            for t in range(tex_stack.shape[0]):
                kd_tex = torch.where((tid == t)[..., None],
                                     texture.sample_bilinear(tex_stack[t], u, v), kd_tex)
            kd_override = torch.where((tid >= 0)[..., None], kd_tex, mats["kd"])
        # the score-function weight is 1.0 in value: only a graph needs it
        bounce_dir, attenuation, emitted = bsdf.shade(
            mats, hit.normal, direction, u1, u2, u3, kd_override=kd_override,
            score_grad=torch.is_grad_enabled(),
        )
        live_hit = (hit.hit & alive)[..., None]
        radiance = radiance + throughput * emitted * live_hit.to(torch.float32)
        throughput = torch.where(live_hit, throughput * attenuation, throughput)
        hit3 = hit.hit[..., None]
        if b == 0:
            # the denoiser's first-hit buffers (miss normal = -dir, path_tracer.cu:152)
            first_n = torch.where(hit3, hit.normal, -direction)
            first_t = torch.where(hit.hit, hit.t, torch.full_like(hit.t, INF))
        alive = alive & hit.hit
        origin = torch.where(hit3, hit.pos, origin)
        direction = torch.where(hit3, mathx.normalize(bounce_dir), direction)
    return radiance, direction, throughput, ~alive, first_n, first_t


def rowmajor_sample(scene, gs, camera, sky_packed, pixel_idx, sample_idx, seed, depth,
                    tex_stack=None):
    """One sample of the row-major body for pixel indices of any shape:
    (radiance f32[..., 3], first_n f32[..., 3], first_t f32[...]), the sky
    seen by the escaped paths included (sampled once per path, as on the
    other paths)."""
    rays = camera.ray_gen(pixel_idx, sample_idx, seed)
    rad, miss_dir, miss_thru, missed, first_n, first_t = trace_bounces_rowmajor(
        scene, gs, rays, pixel_idx, sample_idx, seed, depth, tex_stack=tex_stack)
    sky = texture.sample_sky_packed(sky_packed, miss_dir)
    return rad + miss_thru * sky * missed[..., None].to(torch.float32), first_n, first_t


def sky_epilogue(sky_packed, rad_p, miss_p, thru_p, missed):
    """Radiance f32[R,3]: the gathered radiance plus, on the paths that
    escaped, the throughput times the sky at the miss direction."""
    sky = texture.sample_sky_packed(sky_packed, planar.stack_v3(miss_p))
    return planar.stack_v3(rad_p) + planar.stack_v3(thru_p) * sky * missed[..., None]


def _mega_tex_radiance(gs, tex_stack, hit_planes, aux, miss_p, missed, sky_packed):
    """The textured radiance of one megakernel sample (JAX
    `integrator.py:271-333`).  The kernel's paths do not depend on the
    albedo, so from its winner planes and aux (per bounce the hit position
    and the attenuation-on mask) the recurrence
        rad += thru * (emission_b * kd_b);  thru *= A_b
    is replayed with A_b = the textured albedo (kd where tex_id < 0) times
    the mask; the emission reads the raw kd (`material.cu:36`).  Under
    autograd the records are gathered from float64 copies of the tables,
    values unchanged, so that their cotangents sum in float64."""
    table_s, table_r = gs.table_s, gs.table_r
    if torch.is_grad_enabled():
        table_s, table_r = table_s.double(), table_r.double()
    zero = missed * 0.0
    one = zero + 1.0
    thru = (one, one, one)
    rad = (zero, zero, zero)
    alive = zero < 1.0
    for enc, (pos, att) in zip(hit_planes, aux):
        hit = enc >= 0
        idx = torch.clamp(enc, min=0).long()
        rec = table_s.index_select(0, idx).T.to(torch.float32)
        rec_r = table_r.index_select(0, idx).T.to(torch.float32)
        kd_b = (rec_r[0], rec_r[1], rec_r[2])
        geom_p = (rec[6].to(torch.int32), (rec[0], rec[1], rec[2]), rec[3], rec[4], rec[5])
        kd_att = _textured_kd(rec[11].to(torch.int32), geom_p, pos, tex_stack, kd_b)
        attn = planar.scale_p(kd_att, att)
        live = hit & alive
        lh = live.to(torch.float32)
        rad = planar.add_p(rad, planar.scale_p(planar.mul_p(thru, planar.scale_p(kd_b, rec_r[3])),
                                               lh))
        thru = planar.where_p(live, planar.mul_p(thru, attn), thru)
        alive = alive & hit
    return sky_epilogue(sky_packed, rad, miss_p, thru, missed)


def _per_bounce_sample(scene, gs, camera, sky_packed, pixel_idx, sample_idx, seed, depth,
                       tex_stack):
    """One sample off the megakernel: the planar wavefront body for a
    grouped scene and flat pixel indices unless POCA_PLANAR=0 (JAX
    `integrator.py:72-75`), else the row-major body.  Returns (radiance
    f32[..., 3], first_normal f32[..., 3], first_t f32[...])."""
    if gs is not None and pixel_idx.dim() == 1 and os.environ.get("POCA_PLANAR", "1") != "0":
        rad_p, miss_p, thru_p, missed, fn_p, ft = wavefront_sample(
            gs, camera, pixel_idx, sample_idx, seed, depth, tex_stack)
        return sky_epilogue(sky_packed, rad_p, miss_p, thru_p, missed), planar.stack_v3(fn_p), ft
    return rowmajor_sample(scene, gs, camera, sky_packed, pixel_idx, sample_idx, seed, depth,
                           tex_stack)


def render_sample(scene, camera, sky_tex, pixel_idx, sample_idx, seed, max_depth: int,
                  tex_stack=None):
    """One sample-per-pixel pass of the per-bounce paths (JAX
    `integrator.py:335-343`) over pixel indices: flat (R,) for a grouped
    scene, any shape for a scene without type metadata.  Returns
    (radiance f32[..., 3], first_normal f32[..., 3], first_t f32[...]);
    differentiable."""
    return _per_bounce_sample(scene, fast.group_scene(scene), camera,
                              texture.pack_bilinear(sky_tex), pixel_idx, sample_idx, seed,
                              max_depth, tex_stack)


def _check_devices(scene, camera, sky_tex, tex_stack):
    dev = scene.device
    if camera.device != dev or sky_tex.device != dev or (
            tex_stack is not None and tex_stack.device != dev):
        raise ValueError(
            f"scene, camera, sky and textures must share a device: {dev}, {camera.device}, "
            f"{sky_tex.device}{'' if tex_stack is None else ', ' + str(tex_stack.device)}"
        )


def _spp_chunk(spp: int, spp_chunk: int) -> int:
    """The samples traced as one batch: `spp_chunk`, or POCA_SPP_CHUNK (a
    positive integer) over it, at most spp, and 1 unless it divides spp."""
    env_chunk = os.environ.get("POCA_SPP_CHUNK", "")
    if env_chunk.isdigit() and int(env_chunk) > 0:
        spp_chunk = int(env_chunk)
    spp_chunk = max(1, min(spp_chunk, spp))
    return 1 if spp % spp_chunk else spp_chunk


@dataclasses.dataclass
class _Prepared:
    """What every sample of a render reads: the grouped scene (None for a
    scene without type metadata), the packed sky, the pixel indices of a
    chunk of samples and their sample offsets within it, and the route."""

    gs: fast.GroupedScene | None
    sky_packed: texture.PackedTexture
    pix_c: torch.Tensor
    samp_rep: torch.Tensor | None
    r_n: int
    chunk: int
    use_mega: bool


def _prepare(scene, sky_tex, pixel_idx, chunk: int) -> _Prepared:
    dev = scene.device
    r_n = pixel_idx.shape[0]
    if chunk > 1:
        pix_c = pixel_idx.repeat(chunk)
        samp_rep = torch.arange(chunk, dtype=torch.int32, device=dev).repeat_interleave(r_n)
    else:
        pix_c, samp_rep = pixel_idx, None
    gs = fast.group_scene(scene)
    use_mega = gs is not None and not fast.use_bvh(gs) and os.environ.get("POCA_MEGA", "") != "0"
    return _Prepared(gs, texture.pack_bilinear(sky_tex), pix_c, samp_rep, r_n, chunk, use_mega)


def _sample(prep: _Prepared, scene, camera, key, seed, max_depth: int, tex_stack):
    """One chunk of samples from sample `key` (an int, or an i32 device
    tensor: a CUDA graph's key buffer) on the route of `prep`: (radiance
    f32[..., 3] summed over the chunk, first_normal, first_t of its first
    sample)."""
    s_key = key if prep.samp_rep is None else key + prep.samp_rep
    if prep.use_mega:
        textured = tex_stack is not None
        rad_p, miss_p, thru_p, missed, fn_p, ft, hits, *aux = mega_sample(
            prep.gs, camera, prep.pix_c, s_key, seed, max_depth, with_aux=textured
        )
        if textured:
            rad = _mega_tex_radiance(prep.gs, tex_stack, hits, aux[0], miss_p, missed,
                                     prep.sky_packed)
        else:
            rad = sky_epilogue(prep.sky_packed, rad_p, miss_p, thru_p, missed)
        n0 = planar.stack_v3(fn_p)
    else:
        rad, n0, ft = _per_bounce_sample(scene, prep.gs, camera, prep.sky_packed, prep.pix_c,
                                         s_key, seed, max_depth, tex_stack)
    if prep.chunk > 1:
        rad = rad.reshape(prep.chunk, prep.r_n, 3).sum(0)
        n0, ft = n0[:prep.r_n], ft[:prep.r_n]
    return rad, n0, ft


def _accumulate(prep: _Prepared, scene, camera, key0, spp: int, seed, max_depth: int, tex_stack,
               pixel_shape):
    """The sample loop of :func:`render_radiance` from sample key `key0`
    (an int, or an i32 device tensor): (mean radiance, first_normal,
    first_t of sample 0)."""
    acc_rad = torch.zeros((*pixel_shape, 3), dtype=torch.float32, device=scene.device)
    acc_n = acc_t = None
    for s in range(spp // prep.chunk):
        rad, n0, ft = _sample(prep, scene, camera, key0 + s * prep.chunk, seed, max_depth,
                              tex_stack)
        acc_rad = acc_rad + rad
        if s == 0:
            acc_n, acc_t = n0, ft
    return div_const(acc_rad, float(spp)), acc_n, acc_t


def render_radiance(scene, camera, sky_tex, *, spp: int, max_depth: int, seed=0,
                    pixel_idx=None, sample_offset=0, tex_stack=None,
                    spp_chunk: int = 1):
    """Mean radiance over `spp` samples on the device the scene lives on.

    Returns (radiance f32[..., 3], first_normal f32[..., 3], first_t
    f32[...]) over the pixel indices (default: every pixel, flat); the aux
    buffers come from sample 0.  `spp_chunk` samples are traced as
    one [spp_chunk * R] batch with per-ray sample keys (same draws, same
    paths; only the order of the float32 sum changes); POCA_SPP_CHUNK, a
    positive integer, overrides it, as in the JAX package, so that a knob
    sweep that sets the environment (as ``scripts/perf_knobs.py`` does for
    the JAX package) sets the port's batch the same way.  `tex_stack`
    f32[T, H, W, 3] textures the albedo of objects whose tex_id is >= 0.
    `sample_offset` and `seed` may also be i32 0-dim device tensors (a
    CUDA graph's key and seed buffers, as JAX traces both): the kernels
    read the seed on the device, so one capture serves every seed.
    The result is differentiable w.r.t. the scene's material and geometry
    fields, the camera, the sky and the texture stack whenever they
    require grad, on every path (the backward of each sample is
    ``ops/mega.py::MegaSample``, :class:`WavefrontSample` or autograd of
    the row-major body).  This is the eager form, one PyTorch operation at
    a time; serving calls :func:`render_radiance_jit`, its CUDA graph, and
    the compiled training steps (``inverse.make_train_step``,
    ``bench.train_step_jit``) capture it whole, backward included.
    """
    _check_devices(scene, camera, sky_tex, tex_stack)
    if pixel_idx is None:
        pixel_idx = torch.arange(camera.width * camera.height, dtype=torch.int32,
                                 device=scene.device)
    prep = _prepare(scene, sky_tex, pixel_idx, _spp_chunk(spp, spp_chunk))
    return _accumulate(prep, scene, camera, sample_offset, spp, seed, max_depth, tex_stack,
                      pixel_idx.shape)


# The CUDA graphs of render_radiance_jit, as jax.jit caches its programs:
# a few keys, least recently used first out; RENDER_GRAPHS.clear() frees them.
RENDER_GRAPHS = GraphedCall(max_entries=4)


def render_radiance_jit(scene, camera, sky_tex, *, spp: int, max_depth: int, seed=0,
                        pixel_idx=None, sample_offset=0, tex_stack=None,
                        spp_chunk: int = 1):
    """:func:`render_radiance` compiled, the counterpart of JAX
    `integrator.py:515-517`: same arguments, same result, bit for bit.

    On the card, one CUDA graph of a chunk of samples (ray generation, the
    tables, the sample on the route render_radiance takes, its epilogue,
    the sum into a static accumulator; the first chunk's also keeps the
    first-hit normal and t) is captured once per key of
    :data:`RENDER_GRAPHS` and replayed spp / spp_chunk times, the sample
    key advanced inside the graph; capture time and graph memory do not
    grow with spp.  The key is what the graph bakes in: every input's
    shape and dtype, spp, the chunk, max_depth and the POCA_* switches
    that choose the route.  New values of the same shapes (a moved
    camera, an edited or refitted scene, another sky, other textures or
    pixel indices, another sample_offset, another seed: JAX traces both,
    and the kernels read the seed from the graph's seed buffer) are
    copied into the graph's buffers and replay it.  The outputs are the caller's own
    tensors (copies of the graph's buffers).  Inputs that require grad
    under grad mode raise ValueError: this is the serving call (a
    compiled training step is ``inverse.make_train_step``'s, or
    ``bench.train_step_jit``).  A capture that fails raises; nothing runs
    eagerly in its place.

    On the CPU it is :func:`render_radiance`.
    """
    if scene.device.type == "cpu":
        return render_radiance(scene, camera, sky_tex, spp=spp, max_depth=max_depth, seed=seed,
                               pixel_idx=pixel_idx, sample_offset=sample_offset,
                               tex_stack=tex_stack, spp_chunk=spp_chunk)
    return render_graphed(RENDER_GRAPHS, scene, camera, sky_tex, spp=spp, max_depth=max_depth,
                          seed=seed, pixel_idx=pixel_idx, sample_offset=sample_offset,
                          tex_stack=tex_stack, spp_chunk=spp_chunk)


def render_key(scene, camera, sky_tex, *, spp: int, max_depth: int, pixel_idx=None,
               tex_stack=None, spp_chunk: int = 1):
    """The cache key of :func:`render_radiance_jit`'s graphs for these
    arguments (the seed is not in it: a replay reads it from a buffer)."""
    inputs = (scene, camera, sky_tex, tex_stack, pixel_idx)
    return ("render", signature(inputs), spp, _spp_chunk(spp, spp_chunk), max_depth,
            env_switches())


def render_graphed(runner: GraphedCall, scene, camera, sky_tex, *, spp: int, max_depth: int,
                   seed=0, pixel_idx=None, sample_offset=0, tex_stack=None,
                   spp_chunk: int = 1):
    """:func:`render_radiance_jit`'s body on the graphs of `runner` (its
    capture backend decides what a capture is).  Returns the caller's own
    tensors: copies of the graph's buffers, which its next replay
    overwrites."""
    e = render_replay(runner, scene, camera, sky_tex, spp=spp, max_depth=max_depth, seed=seed,
                      pixel_idx=pixel_idx, sample_offset=sample_offset, tex_stack=tex_stack,
                      spp_chunk=spp_chunk)
    return div_const(e.acc, float(spp)), e.first_n.clone(), e.first_t.clone()


def render_replay(runner: GraphedCall, scene, camera, sky_tex, *, spp: int, max_depth: int,
                  seed=0, pixel_idx=None, sample_offset=0, tex_stack=None, spp_chunk: int = 1,
                  tail=None):
    """Copy the inputs, the sample offset and the seed into the buffers of
    this key's render entry (captured on first use) and replay its chunk
    graphs: the entry, whose `acc` then holds the radiance summed over the
    samples and `first_n`, `first_t` the first-hit buffers, until the
    entry's next replay.

    `tail`, a pair (name, make), adds the work that follows the render to
    the entry: ``make(e)``, called once as the entry is built, sets up its
    static buffers and returns the body of one more graph, replayed after
    the chunks, that reads the entry's buffers (``video.render_video``'s
    denoise and pack); `name` goes into the key."""
    with obs.span("render.call") as call:
        _check_devices(scene, camera, sky_tex, tex_stack)
        inputs = (scene, camera, sky_tex, tex_stack, pixel_idx)
        if torch.is_grad_enabled() and requires_grad(*inputs):
            raise ValueError(
                "render_radiance_jit serves frames and takes no inputs that require grad: train "
                "through inverse.make_train_step or bench.train_step_jit (compiled on the card), "
                "or call render_radiance, or wrap the call in torch.no_grad()"
            )
        chunk = _spp_chunk(spp, spp_chunk)

        def key():
            k = render_key(scene, camera, sky_tex, spp=spp, max_depth=max_depth,
                           pixel_idx=pixel_idx, tex_stack=tex_stack, spp_chunk=spp_chunk)
            return k if tail is None else k + (tail[0],)

        e = runner.entry(key, lambda r: _capture_render(r, inputs, spp // chunk, chunk,
                                                        max_depth, tail and tail[1]))
        with obs.span("graphs.copy_in") as sp:
            copy_into(e.inputs, inputs, sp)
            e.key.fill_(sample_offset)
            write_seed(e.seed, seed)
        for g in e.order:
            g.replay()
        call.count("replays", len(e.order))
        for k, v in e.mega_counts.items():
            call.count(k, v)
        return e


def _capture_render(runner, inputs, n_chunks: int, chunk: int, max_depth: int, tail=None):
    """The entry of one render key: static inputs, the key, seed and
    accumulator buffers, and the graphs of the first chunk (which also
    prepares the tables and keeps the first-hit buffers), when
    spp > chunk of a later chunk, and of the body `tail(e)` returns when
    given; `e.order` lists them as a replay runs them."""
    e = Entry()
    e.inputs = static_twin(inputs)
    scene, camera, sky_tex, tex_stack, pixel_idx = e.inputs
    dev = scene.device
    if pixel_idx is None:
        pixel_idx = torch.arange(camera.width * camera.height, dtype=torch.int32, device=dev)
    e.key = torch.zeros((), dtype=torch.int32, device=dev)
    e.seed = torch.zeros((), dtype=torch.int32, device=dev)
    e.acc = torch.zeros((*pixel_idx.shape, 3), dtype=torch.float32, device=dev)

    def first():
        with torch.no_grad():
            e.prep = _prepare(scene, sky_tex, pixel_idx, chunk)
            rad, e.first_n, e.first_t = _sample(e.prep, scene, camera, e.key, e.seed, max_depth,
                                                tex_stack)
            e.acc.zero_().add_(rad)  # render_radiance's zeros + rad
            e.key.add_(chunk)

    def later():
        with torch.no_grad():
            rad, _, _ = _sample(e.prep, scene, camera, e.key, e.seed, max_depth, tex_stack)
            e.acc.add_(rad)
            e.key.add_(chunk)

    chunks = [first] + [later] * (n_chunks > 1)
    tails = [] if tail is None else [tail(e)]
    e.graphs = runner.capture(*chunks, *tails, device=dev)
    g = e.graphs
    e.order = g[:1] + g[1:len(chunks)] * (n_chunks - 1) + g[len(chunks):]
    # the megakernel's launch shape, read once here and counted by every call's span
    e.mega_counts = {}
    if e.prep.use_mega and dev.type == "cuda":
        with torch.cuda.device(dev):
            e.mega_counts = mega_kernel.launch_counts(e.prep.gs, e.prep.pix_c.shape[0],
                                                      with_aux=tex_stack is not None)
    return e
