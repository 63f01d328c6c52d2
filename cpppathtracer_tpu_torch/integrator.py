"""Monte-Carlo radiance over many samples (counterpart of the megakernel
branch of ``cpppathtracer_tpu/integrator.py::render_radiance``).

Loop semantics of the reference (`cuSrc/path_tracer.cu:141-170`) live in
the megakernel (ops/cuda/mega_kernel.py); here each sample adds the sky
seen by the escaped paths, sampled once per path at its recorded miss
direction and throughput.  The sky epilogue is plain torch, so its
gradient reaches the sky texture through `pack_bilinear` and the miss
direction, as in the JAX package (`integrator.py:447-452`).  The first-hit normal and t of sample 0 feed the
denoiser (`path_tracer.cu:159-163`; t in place of the reference's constant
depth buffer, as the JAX package does).
"""

from __future__ import annotations

import torch

from cpppathtracer_tpu_torch.ops import planar, texture
from cpppathtracer_tpu_torch.ops.fast import group_scene
from cpppathtracer_tpu_torch.ops.mathx import div_const
from cpppathtracer_tpu_torch.ops.mega import mega_sample


def render_radiance(scene, camera, sky_tex, *, spp: int, max_depth: int, seed: int = 0,
                    pixel_idx=None, sample_offset: int = 0, tex_stack=None,
                    spp_chunk: int = 1):
    """Mean radiance over `spp` samples on the device the scene lives on.

    Returns (radiance f32[R,3], first_normal f32[R,3], first_t f32[R]);
    the aux buffers come from sample 0.  `spp_chunk` samples are traced as
    one [spp_chunk * R] batch with per-ray sample keys (same draws, same
    paths; only the order of the float32 sum changes).  Differentiable
    w.r.t. the scene's material and geometry fields, the camera and the
    sky whenever they require grad (the backward of each sample is
    ``ops/mega.py::MegaSample``); the serving path calls it under
    torch.no_grad().
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

    gs = group_scene(scene)
    sky_packed = texture.pack_bilinear(sky_tex)
    acc_rad = torch.zeros((r_n, 3), dtype=torch.float32, device=dev)
    acc_n = acc_t = None
    for s in range(spp // spp_chunk):
        s_key = sample_offset + s * spp_chunk
        if samp_rep is not None:
            s_key = s_key + samp_rep
        rad_p, miss_p, thru_p, missed, fn_p, ft, _ = mega_sample(
            gs, camera, pix_c, s_key, seed, max_depth
        )
        sky = texture.sample_sky_packed(sky_packed, planar.stack_v3(miss_p))
        rad = planar.stack_v3(rad_p) + planar.stack_v3(thru_p) * sky * missed[..., None]
        n0 = planar.stack_v3(fn_p)
        if spp_chunk > 1:
            rad = rad.reshape(spp_chunk, r_n, 3).sum(0)
            n0, ft = n0[:r_n], ft[:r_n]
        acc_rad = acc_rad + rad
        if s == 0:
            acc_n, acc_t = n0, ft
    return div_const(acc_rad, float(spp)), acc_n, acc_t
