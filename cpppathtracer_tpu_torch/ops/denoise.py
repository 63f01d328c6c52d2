"""Edge-avoiding 5x5 denoiser (counterpart of
``cpppathtracer_tpu/ops/denoise.py``; reference `Denoising`,
`cuSrc/path_tracer.cu:177-239`).

Fixed 5x5 Gaussian tap weights times per-tap color / normal / depth
similarity terms exp(-dist^2 / pi); out = sum(w*k*c) / sum(w*k).  Taps
outside the image get zero weight in 2D, as in the JAX package (the
reference wraps rows horizontally).  Plain PyTorch: the JAX package has
no Pallas kernel here either.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _pad_hw(a, r):
    """Zero-pad the two leading (H, W) dims by r."""
    if a.dim() == 2:
        return F.pad(a, (r, r, r, r))
    return F.pad(a, (0, 0, r, r, r, r))


def denoise(radiance, normal, depth, stepwidth: int = 1):
    """radiance f32[H,W,3], normal f32[H,W,3], depth f32[H,W] ->
    f32[H,W,3]."""
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
            c_w = torch.exp(-(cd * cd).sum(-1) * _INV_PI)
            n_w = torch.exp(-(nd * nd).sum(-1) * _INV_PI)
            p_w = torch.exp(-(pd * pd) * _INV_PI)
            wgt = (c_w * n_w * p_w * sl(valid_p) * k)[..., None]
            num = num + wgt * ctmp
            den = den + wgt
    return num / den
