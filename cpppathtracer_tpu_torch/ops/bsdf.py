"""The score-function weight of the BSDF's Bernoulli branch choices
(counterpart of ``cpppathtracer_tpu/ops/bsdf.py::_score_weight``).

The branch choices themselves (`u3 < reflectivity` for MIRROR,
`u3 < reflect_prob` for GLASS, `material.cu:77-89, 133`) are comparisons and
carry no gradient.  Multiplying the attenuation by w = p / detach(p) for the
branch taken (or (1-p) / detach(1-p) for the one skipped) leaves the forward
value exactly 1.0 and adds d log p / dtheta times everything downstream to
the backward: the likelihood-ratio estimator.  It is the only source of the
`reflectivity` gradient and of the Fresnel part of the `ior` gradient.
"""

from __future__ import annotations

import torch


def _branch(took, p):
    """p / detach(p) where the branch was taken, (1-p) / detach(1-p) where
    it was not.  Double-where guard: a branch whose probability is 0 (say
    reflectivity == 0, or total internal reflection where reflect_prob == 1)
    divides by a dummy 1 instead of 0, so its lane never evaluates 0/0."""
    p_det = p.detach()
    w_take = p / torch.where(p_det > 0, p_det, torch.ones_like(p_det))
    q = 1.0 - p
    q_det = q.detach()
    w_skip = q / torch.where(q_det > 0, q_det, torch.ones_like(q_det))
    return torch.where(took, w_take, w_skip)


def _score_weight(is_mirror, mirror_reflects, reflectivity, is_glass, glass_reflects,
                  reflect_prob):
    """The weight f32[R]: 1.0 in value; in the backward the log-derivative
    of the MIRROR choice's probability (reflectivity) and of the GLASS
    choice's (reflect_prob, Schlick's Fresnel term)."""
    one = torch.ones_like(reflectivity)
    w = torch.where(is_mirror, _branch(mirror_reflects, reflectivity), one)
    return w * torch.where(is_glass, _branch(glass_reflects, reflect_prob), one)
