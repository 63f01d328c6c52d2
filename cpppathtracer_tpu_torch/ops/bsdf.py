"""BSDF sampling on row-major tensors and the score-function weight of
its Bernoulli branch choices (counterpart of
``cpppathtracer_tpu/ops/bsdf.py``; the planar bounce body's twin of
:func:`shade` is ``planar.shade_p``).

Per material type (`cuSrc/material.cu:20-163`; see `types.MaterialType`
for the reference's crossed names): DIFFUSE a cosine lobe around the
normal; METAL a Phong lobe, alpha = 1000^smoothness, around the mirror
direction; MIRROR the METAL lobe with probability reflectivity, else the
DIFFUSE one; GLASS Snell refraction against Schlick's Fresnel reflection
(always reflecting under total internal reflection), perturbed by the
Phong lobe.  The attenuation is kd above the horizon and 0 below it,
except for GLASS (always kd, material.cu:140); every material emits
emission * kd.  One lobe and one `to_world` with a per-lane exponent and
axis serve all four.

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

from cpppathtracer_tpu_torch.ops import mathx
from cpppathtracer_tpu_torch.ops.intersect import take_rows
from cpppathtracer_tpu_torch.types import MaterialType


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


def shade(mat, normal, in_dir, u1, u2, u3, kd_override=None, score_grad=True):
    """Sample the bounce of each hit.

    mat: :func:`gather_materials`'s dict (mat_type i32[R], kd f32[R, 3],
    emission, smoothness, reflectivity, ior f32[R]); normal and in_dir
    f32[R, 3]; u1, u2, u3 f32[R] uniforms.  `kd_override` f32[R, 3] (the
    textured albedo, `Material::GetKd`, material.cu:11-18) replaces kd in
    the attenuation only: the emission reads the raw kd.  With
    `score_grad` the attenuation carries :func:`_score_weight`.

    Returns (bounce_dir f32[R, 3], unnormalized as `path_tracer.cu:166`
    leaves it to the caller; attenuation f32[R, 3]; emitted f32[R, 3]).
    """
    mat_type = mat["mat_type"]
    kd = mat["kd"]
    smoothness = mat["smoothness"]
    reflectivity = mat["reflectivity"]
    ior = mat["ior"]

    is_metal = mat_type == MaterialType.METAL
    is_mirror = mat_type == MaterialType.MIRROR
    is_glass = mat_type == MaterialType.GLASS
    # any other type (TEST included) runs the diffuse shader, the
    # reference's `default:` (material.cu:160-161)
    is_diffuse = ~(is_metal | is_mirror | is_glass)

    alpha_phong = torch.pow(torch.full_like(smoothness, 1000.0), smoothness)
    reflect_dir = mathx.reflect(in_dir, normal)
    # MIRROR's branch (material.cu:77-89): a comparison, no gradient
    mirror_reflects = u3 < reflectivity

    # GLASS's Fresnel set-up (material.cu:109-132)
    d_dot_n = mathx.dot(in_dir, normal)
    inside = d_dot_n > 0
    outward_n = torch.where(inside[..., None], -normal, normal)
    ni_over_nt = torch.where(inside, ior, 1.0 / torch.where(ior == 0, torch.ones_like(ior), ior))
    cos_arg = 1.0 - ior * ior * (1.0 - d_dot_n * d_dot_n)
    pos_arg = cos_arg > 0
    cos_in = torch.sqrt(torch.where(pos_arg, cos_arg, torch.ones_like(cos_arg)))
    cos_in = torch.where(pos_arg, cos_in, torch.zeros_like(cos_in))
    cosine = torch.where(inside, cos_in, -d_dot_n)
    refracted, refract_ok = mathx.refract(in_dir, outward_n, ni_over_nt)
    reflect_prob = torch.where(refract_ok, mathx.schlick(cosine, ior), torch.ones_like(cosine))
    glass_reflects = u3 < reflect_prob

    two = torch.full_like(alpha_phong, 2.0)
    alpha = torch.where(is_diffuse, two, torch.where(is_mirror & ~mirror_reflects, two, alpha_phong))
    col = lambda m: m[..., None]
    base = torch.where(
        col(is_diffuse),
        normal,
        torch.where(
            col(is_mirror),
            torch.where(col(mirror_reflects), reflect_dir, normal),
            torch.where(
                col(is_glass),
                torch.where(col(glass_reflects), reflect_dir, refracted),
                reflect_dir,  # METAL
            ),
        ),
    )

    bounce_dir = mathx.to_world(mathx.phong_lobe_local(u1, u2, alpha), base)

    above_horizon = mathx.dot(normal, bounce_dir) > 0
    atten_on = is_glass | above_horizon
    atten_kd = kd if kd_override is None else kd_override
    attenuation = torch.where(col(atten_on), atten_kd, torch.zeros_like(atten_kd))
    if score_grad:
        w = _score_weight(is_mirror, mirror_reflects, reflectivity, is_glass, glass_reflects,
                          reflect_prob)
        attenuation = attenuation * w[..., None]
    emitted = mat["emission"][..., None] * kd
    return bounce_dir, attenuation, emitted


def gather_materials(scene, obj_idx):
    """Each ray's material fields from the scene's tables, at object
    obj_idx (i32[...], clamped to >= 0), with the object's geometry under
    "_geom" (prim_type, center, radius, y_pos, height) for the hit UVs.
    The fetch is ``intersect.take_rows``."""
    idx = torch.clamp(obj_idx, min=0).long()
    take = lambda a: take_rows(a, idx)
    return {
        "mat_type": take(scene.mat_type),
        "kd": take(scene.kd),
        "emission": take(scene.emission),
        "smoothness": take(scene.smoothness),
        "reflectivity": take(scene.reflectivity),
        "ior": take(scene.ior),
        "tex_id": take(scene.tex_id),
        "_geom": (take(scene.prim_type), take(scene.center), take(scene.radius),
                  take(scene.y_pos), take(scene.height)),
    }
