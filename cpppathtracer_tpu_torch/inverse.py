"""Inverse rendering: fit material (and optionally sky) parameters to a
target image by gradient descent through the differentiable render
(counterpart of ``cpppathtracer_tpu/inverse.py``).

The train step is render -> L2 loss -> backward -> Adam update, with Adam
at optax's defaults (betas 0.9 / 0.999, eps 1e-8 added to the root of the
second moment).  The pixel-tile sharded step waits for the multi-device
slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from cpppathtracer_tpu_torch.integrator import render_radiance


@dataclasses.dataclass
class InverseConfig:
    spp: int = 4
    max_depth: int = 4
    seed: int = 0
    learning_rate: float = 5e-2
    optimize_sky: bool = False
    # which material fields to optimize (a subset of Scene.material_params())
    fields: tuple = ("kd", "emission", "smoothness", "reflectivity", "ior")
    # True: every step re-uses the target's sample set (a deterministic
    # estimator, the loss can reach ~0); False: fresh samples per step
    # (decorrelated Monte-Carlo noise, the loss floors at the noise level)
    fixed_samples: bool = False


def render_for_loss(scene, camera, sky_tex, cfg: InverseConfig, sample_offset: int = 0):
    rad, _, _ = render_radiance(
        scene, camera, sky_tex, spp=cfg.spp, max_depth=cfg.max_depth, seed=cfg.seed,
        sample_offset=sample_offset,
    )
    return rad


def make_train_step(camera, cfg: InverseConfig):
    """Single-device train step.

    Returns (init, train_step): `init(scene, sky_tex)` gives (params,
    opt), where params is a dict of leaf tensors (cfg.fields, plus "sky"
    with cfg.optimize_sky) and opt the optimizer over them;
    `train_step(params, opt, scene, sky_tex, target, step)` updates both
    in place and returns (params, opt, loss), the loss of the parameters
    before the update.  `target` is f32[H*W, 3] flat radiance.
    """

    def loss_fn(params, scene, sky_tex, target, step):
        mat = {k: v for k, v in params.items() if k != "sky"}
        scene = scene.with_material_params({**scene.material_params(), **mat})
        sky = params.get("sky", sky_tex)
        offset = 0 if cfg.fixed_samples else step * cfg.spp
        rad = render_for_loss(scene, camera, sky, cfg, sample_offset=offset)
        return torch.mean((rad - target) ** 2)

    def train_step(params, opt, scene, sky_tex, target, step):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, scene, sky_tex, target, step)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    def init(scene, sky_tex):
        full = scene.material_params()
        params = {k: full[k].detach().clone().requires_grad_(True) for k in cfg.fields}
        if cfg.optimize_sky:
            params["sky"] = sky_tex.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam(list(params.values()), lr=cfg.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        return params, opt

    return init, train_step


def fit(scene, camera, sky_tex, target, cfg: InverseConfig, steps: int = 100, callback=None):
    """Run the optimization loop; `callback(step, loss, params)` after each
    step.  Returns (optimized_scene, losses)."""
    init, train_step = make_train_step(camera, cfg)
    params, opt = init(scene, sky_tex)
    target = torch.as_tensor(target, dtype=torch.float32, device=scene.device).reshape(-1, 3)
    losses = []
    for step in range(steps):
        params, opt, loss = train_step(params, opt, scene, sky_tex, target, step)
        losses.append(float(loss))
        if callback is not None:
            callback(step, losses[-1], params)
    mat = {k: v.detach() for k, v in params.items() if k != "sky"}
    return scene.with_material_params({**scene.material_params(), **mat}), losses
