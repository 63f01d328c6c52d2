"""The edge-avoiding 5x5 denoiser: its launch and its plain PyTorch version.

Counterpart of ``cpppathtracer_tpu/ops/denoise.py`` (reference `Denoising`,
`cuSrc/path_tracer.cu:177-239`): fixed 5x5 Gaussian tap weights times per-
tap color / normal / depth similarity terms exp(-dist^2 / pi); out =
sum(w*k*c) / sum(w*k).  Taps outside the image get zero weight in 2D, as in
the JAX package (the reference wraps rows horizontally).

The JAX package has no Pallas kernel here: XLA fuses its 25 taps into one
pass of its jitted frame program.  The CUDA kernel ``csrc/denoise.cu`` is
that pass; :func:`denoise_plain` is the same function in plain PyTorch
(25 taps of some 20 small kernels each), which the CPU runs and against
which the kernel is held on the card, bit for bit: both sum each squared
distance over the channels as (c0 + c1) + c2 (written out, as
``ops/mathx.py`` writes its dot products) and round every operation alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cpppathtracer_tpu_torch.ops.cuda import build as kb

KERNEL_5X5 = np.array(
    [
        [1.0, 4.0, 7.0, 4.0, 1.0],
        [4.0, 16.0, 26.0, 16.0, 4.0],
        [7.0, 26.0, 41.0, 26.0, 7.0],
        [4.0, 16.0, 26.0, 16.0, 4.0],
        [1.0, 4.0, 7.0, 4.0, 1.0],
    ],
    np.float32,
)

_INV_PI = float(np.float32(1.0 / np.pi))


def _check(radiance, normal, depth, stepwidth):
    dev = radiance.device
    if radiance.dim() != 3 or radiance.shape[2] != 3:
        raise ValueError(f"radiance has shape {tuple(radiance.shape)}, expected (H, W, 3)")
    h, w = radiance.shape[:2]
    for name, t, shape in (("radiance", radiance, (h, w, 3)), ("normal", normal, (h, w, 3)),
                           ("depth", depth, (h, w))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, radiance on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not isinstance(stepwidth, int) or stepwidth < 0:
        raise ValueError(f"stepwidth must be an int >= 0, got {stepwidth!r}")


def denoise(radiance, normal, depth, stepwidth: int = 1):
    """radiance f32[H,W,3], normal f32[H,W,3], depth f32[H,W] ->
    f32[H,W,3].

    CUDA tensors launch ``csrc/denoise.cu`` (counted in
    ``build.LAUNCHES["denoise"]``) at any stepwidth; CPU tensors take
    :func:`denoise_plain`.
    The kernel has no backward: on CUDA tensors, an input that requires
    grad under grad mode raises ValueError rather than return a result
    with no gradient (:func:`denoise_plain` differentiates on any device).
    Other dtypes, shapes, mixed devices or other device types raise
    ValueError."""
    _check(radiance, normal, depth, stepwidth)
    dev = radiance.device
    if dev.type == "cpu":
        return denoise_plain(radiance, normal, depth, stepwidth)
    if dev.type != "cuda":
        raise ValueError(f"denoise runs on cuda or cpu tensors, got {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (radiance, normal, depth)):
        raise ValueError("the denoise kernel has no backward and its inputs require grad: call "
                         "denoise_plain to differentiate through the denoiser, or wrap the call "
                         "in torch.no_grad()")
    h, w = radiance.shape[:2]
    radiance, normal, depth = (t.contiguous() for t in (radiance, normal, depth))
    out = torch.empty_like(radiance)
    with torch.cuda.device(dev):
        err = kb.library().poca_denoise(radiance.data_ptr(), normal.data_ptr(),
                                        depth.data_ptr(), out.data_ptr(), h, w, stepwidth,
                                        kb.stream_handle(radiance))
    kb.check(err, "denoise")
    kb.LAUNCHES["denoise"] += 1
    return out


def _pad_hw(a, r):
    """Zero-pad the two leading (H, W) dims by r."""
    if a.dim() == 2:
        return F.pad(a, (r, r, r, r))
    return F.pad(a, (0, 0, r, r, r, r))


def _sq_sum3(v):
    """v[..., 0]^2 + v[..., 1]^2 + v[..., 2]^2, summed in that order."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def denoise_plain(radiance, normal, depth, stepwidth: int = 1):
    """Plain PyTorch version of :func:`denoise`, on any device."""
    h, w, _ = radiance.shape
    r = 2 * stepwidth
    rad_p = _pad_hw(radiance, r)
    nrm_p = _pad_hw(normal, r)
    dep_p = _pad_hw(depth, r)
    valid_p = _pad_hw(torch.ones((h, w), dtype=torch.float32, device=radiance.device), r)

    num = torch.zeros_like(radiance)
    den = torch.zeros((h, w, 1), dtype=torch.float32, device=radiance.device)
    for i in range(5):
        for j in range(5):
            dy = (j - 2) * stepwidth  # j indexes the y offset (cu:212)
            dx = (i - 2) * stepwidth
            k = float(KERNEL_5X5[i, j])
            sl = lambda a: a[r + dy: r + dy + h, r + dx: r + dx + w]
            ctmp = sl(rad_p)
            cd = radiance - ctmp
            nd = normal - sl(nrm_p)
            pd = depth - sl(dep_p)
            c_w = torch.exp(-_sq_sum3(cd) * _INV_PI)
            n_w = torch.exp(-_sq_sum3(nd) * _INV_PI)
            p_w = torch.exp(-(pd * pd) * _INV_PI)
            wgt = (c_w * n_w * p_w * sl(valid_p) * k)[..., None]
            num = num + wgt * ctmp
            den = den + wgt
    return num / den
