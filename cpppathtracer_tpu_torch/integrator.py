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
(`integrator.py:416-424`): a scene with BVH tables takes the wavefront
path, whose closest hit walks the BVH (``csrc/bvh.cu``); a dense scene
takes the megakernel (``ops/mega.py``).  POCA_MEGA=0 sends a dense scene
through the wavefront path with the dense winner kernel
(``csrc/winner.cu``), and POCA_BVH=0 ignores attached tables.

The megakernel path is differentiable (its backward is
``ops/mega.py::MegaSample``); the wavefront path serves only and raises
when asked for a gradient.
"""

from __future__ import annotations

import os

import torch

from cpppathtracer_tpu_torch.ops import fast, planar, texture
from cpppathtracer_tpu_torch.ops.mathx import div_const
from cpppathtracer_tpu_torch.ops.mega import mega_sample
from cpppathtracer_tpu_torch.types import INF, TMIN_BOUNCE
from cpppathtracer_tpu_torch.utils.rng import uniforms4


def trace_bounces(gs, sky_packed, rays, pixel_idx, sample_idx, seed, max_depth: int):
    """Integrate `max_depth` bounces of planar primary rays (`rays` = (o, d),
    tuples of f32[R]) over the grouped scene `gs` one bounce at a time,
    each bounce's closest hit by ``fast.intersect_and_gather_planar``; the
    escaped paths see the packed sky `sky_packed`.  A path that missed
    keeps its ray, which misses again, so at the end its direction and
    throughput are the miss direction and throughput.

    Returns (radiance f32[R,3], first_normal f32[R,3], first_t f32[R])."""
    o, d = rays
    zero = torch.zeros_like(o[0])
    one = zero + 1.0
    thru = (one, one, one)
    rad = (zero, zero, zero)
    first_n = (zero, zero, zero)
    first_t = zero
    alive = zero < 1.0
    tmax = zero + INF
    for b in range(max_depth):
        tmin = zero + (0.0 if b == 0 else TMIN_BOUNCE)
        hit, mats = fast.intersect_and_gather_planar(gs, o, d, tmin, tmax)
        u1, u2, u3, _ = uniforms4(seed, pixel_idx, sample_idx, 1 + b)
        bounce_dir, attenuation, emitted = planar.shade_p(
            mats, hit["normal"], d, u1, u2, u3, score_grad=False
        )
        live_hit = hit["hit"] & alive
        lh = live_hit.to(torch.float32)
        rad = planar.add_p(rad, planar.scale_p(planar.mul_p(thru, emitted), lh))
        thru = planar.where_p(live_hit, planar.mul_p(thru, attenuation), thru)
        if b == 0:
            first_n = planar.where_p(hit["hit"], hit["normal"], planar.scale_p(d, -1.0))
            first_t = hit["t"]
        alive = alive & hit["hit"]
        o = planar.where_p(hit["hit"], hit["pos"], o)
        d = planar.where_p(hit["hit"], planar.normalize_p(bounce_dir), d)
    missed = (~alive).to(torch.float32)
    sky = texture.sample_sky_packed(sky_packed, planar.stack_v3(d))
    radiance = planar.stack_v3(rad) + planar.stack_v3(thru) * sky * missed[..., None]
    return radiance, planar.stack_v3(first_n), first_t


def _wants_grad(scene, camera, sky_tex) -> bool:
    if not torch.is_grad_enabled():
        return False
    fields = [v for v in vars(scene).values() if isinstance(v, torch.Tensor)]
    fields += [v for v in vars(camera).values() if isinstance(v, torch.Tensor)]
    return any(t.requires_grad for t in fields + [sky_tex])


def render_radiance(scene, camera, sky_tex, *, spp: int, max_depth: int, seed: int = 0,
                    pixel_idx=None, sample_offset: int = 0, tex_stack=None,
                    spp_chunk: int = 1):
    """Mean radiance over `spp` samples on the device the scene lives on.

    Returns (radiance f32[R,3], first_normal f32[R,3], first_t f32[R]);
    the aux buffers come from sample 0.  `spp_chunk` samples are traced as
    one [spp_chunk * R] batch with per-ray sample keys (same draws, same
    paths; only the order of the float32 sum changes).  On the megakernel
    path the result is differentiable w.r.t. the scene's material and
    geometry fields, the camera and the sky whenever they require grad
    (the backward of each sample is ``ops/mega.py::MegaSample``); the
    wavefront path raises NotImplementedError for a gradient.  The serving
    path calls it under torch.no_grad().
    """
    if tex_stack is not None:
        raise NotImplementedError("textured albedo is not ported yet")
    dev = scene.device
    if camera.device != dev or sky_tex.device != dev:
        raise ValueError(
            f"scene, camera and sky must share a device: {dev}, {camera.device}, {sky_tex.device}"
        )
    if pixel_idx is None:
        pixel_idx = torch.arange(camera.width * camera.height, dtype=torch.int32, device=dev)
    spp_chunk = max(1, min(spp_chunk, spp))
    if spp % spp_chunk:
        spp_chunk = 1
    r_n = pixel_idx.shape[0]
    if spp_chunk > 1:
        pix_c = pixel_idx.repeat(spp_chunk)
        samp_rep = torch.arange(spp_chunk, dtype=torch.int32, device=dev).repeat_interleave(r_n)
    else:
        pix_c, samp_rep = pixel_idx, None

    gs = fast.group_scene(scene)
    sky_packed = texture.pack_bilinear(sky_tex)
    use_mega = not fast.use_bvh(gs) and os.environ.get("POCA_MEGA", "") != "0"
    if not use_mega and _wants_grad(scene, camera, sky_tex):
        raise NotImplementedError(
            "gradients through the wavefront path (BVH scenes, POCA_MEGA=0) are not "
            "ported yet; render under torch.no_grad()"
        )

    acc_rad = torch.zeros((r_n, 3), dtype=torch.float32, device=dev)
    acc_n = acc_t = None
    for s in range(spp // spp_chunk):
        s_key = sample_offset + s * spp_chunk
        if samp_rep is not None:
            s_key = s_key + samp_rep
        if use_mega:
            rad_p, miss_p, thru_p, missed, fn_p, ft, _ = mega_sample(
                gs, camera, pix_c, s_key, seed, max_depth
            )
            sky = texture.sample_sky_packed(sky_packed, planar.stack_v3(miss_p))
            rad = planar.stack_v3(rad_p) + planar.stack_v3(thru_p) * sky * missed[..., None]
            n0 = planar.stack_v3(fn_p)
        else:
            pix = pix_c.to(torch.int32)
            samp = torch.as_tensor(s_key, dtype=torch.int32, device=dev).expand(pix.shape[0])
            rays = camera.ray_gen_planar(pix, samp, seed)
            rad, n0, ft = trace_bounces(gs, sky_packed, rays, pix, samp, seed, max_depth)
        if spp_chunk > 1:
            rad = rad.reshape(spp_chunk, r_n, 3).sum(0)
            n0, ft = n0[:r_n], ft[:r_n]
        acc_rad = acc_rad + rad
        if s == 0:
            acc_n, acc_t = n0, ft
    return div_const(acc_rad, float(spp)), acc_n, acc_t
