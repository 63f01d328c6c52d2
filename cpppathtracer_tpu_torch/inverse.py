"""Inverse rendering: fit material (and optionally sky) parameters to a
target image by gradient descent through the differentiable render
(counterpart of ``cpppathtracer_tpu/inverse.py``).

The train step is render -> L2 loss -> backward -> Adam update, with Adam
at optax's defaults (betas 0.9 / 0.999, eps 1e-8 added to the root of the
second moment).  :func:`make_sharded_train_step` is the same step over a
pixel-tile mesh (``parallel/render.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.parallel.distributed import process_rows, world
from cpppathtracer_tpu_torch.parallel.render import global_pixel_grid, make_sharded_loss


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
        params = _leaf_params(scene, cfg)
        if cfg.optimize_sky:
            params["sky"] = sky_tex.detach().clone().requires_grad_(True)
        return params, _adam(params, cfg)

    return init, train_step


def _leaf_params(scene, cfg: InverseConfig):
    full = scene.material_params()
    return {k: full[k].detach().clone().requires_grad_(True) for k in cfg.fields}


def _adam(params, cfg: InverseConfig):
    return torch.optim.Adam(list(params.values()), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


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


def make_sharded_train_step(mesh, camera, cfg: InverseConfig):
    """The train step over a pixel-tile mesh: the tiles' loss
    (``parallel.render.make_sharded_loss``), its backward, and Adam on
    parameters and optimizer state that every process holds whole.

    Returns (init, train_step): `init(scene, target_image)` gives (params,
    opt, pix, target), pix the global pixel grid of this process's rows and
    target those rows of the f32[H*W, 3] (or [H, W, 3]) image, both padded
    to the mesh tiling; `train_step(params, opt, scene, sky_tex, pix,
    target)` updates params and opt in place and returns (params, opt,
    loss), the loss of the parameters before the update.  With a
    ``torch.distributed`` group of more than one process each process
    renders its own rows, and the loss and the parameter gradients are
    all-reduced before the update, so every process takes the same step.
    """
    loss_fn = make_sharded_loss(mesh, cfg.spp, cfg.max_depth, cfg.seed)

    def train_step(params, opt, scene, sky_tex, pix, target):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, scene, camera, sky_tex, pix, target)
        loss.backward()
        loss = loss.detach()
        if world()[0] > 1:
            dist.all_reduce(loss)
            for p in params.values():
                dist.all_reduce(p.grad)
        opt.step()
        return params, opt, loss

    def init(scene, target_image):
        params = _leaf_params(scene, cfg)
        lo, hi = process_rows(camera.height)
        pix = global_pixel_grid(camera, mesh, (lo, hi))
        h, w = camera.height, camera.width
        image = torch.as_tensor(target_image, dtype=torch.float32).reshape(h, w, 3)
        tgt = torch.zeros((*pix.shape, 3), dtype=torch.float32, device=pix.device)
        tgt[:hi - lo, :w] = image[lo:hi].to(pix.device)
        return params, _adam(params, cfg), pix, tgt

    return init, train_step
