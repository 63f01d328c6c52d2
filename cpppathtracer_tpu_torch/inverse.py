"""Inverse rendering: fit material (and optionally sky) parameters to a
target image by gradient descent through the differentiable render
(counterpart of ``cpppathtracer_tpu/inverse.py``).

The train step is render -> L2 loss -> gradients -> Adam update, with
optax.adam's update in optax's order (:func:`adam_update`; betas 0.9 /
0.999, eps 1e-8 added to the root of the second moment) on explicit state
tensors (:class:`AdamState`).  On the card :func:`make_train_step`'s step
is one CUDA graph (``utils/graphs.py``), the counterpart of JAX's jitted
``train_step``; the eager step runs the same operations.
:func:`make_sharded_train_step` is the step over a pixel-tile mesh
(``parallel/render.py``), eager.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.parallel.distributed import process_rows, world
from cpppathtracer_tpu_torch.parallel.render import global_pixel_grid, make_sharded_loss
from cpppathtracer_tpu_torch.utils.graphs import (
    Entry,
    GraphedCall,
    copy_into,
    env_switches,
    signature,
    static_twin,
)


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


@dataclasses.dataclass
class AdamState:
    """optax.adam's state (``ScaleByAdamState``): the first and second
    moments of each parameter, keyed as the parameters are, and the step
    count, an i32 0-dim tensor on their device."""

    mu: dict
    nu: dict
    count: torch.Tensor


# optax.adam's defaults: eps outside the root, eps_root 0
B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_init(params) -> AdamState:
    """optax.adam's init: zero moments and a zero count."""
    dev = next(iter(params.values())).device
    zeros = lambda: {k: torch.zeros_like(v.detach()) for k, v in params.items()}
    return AdamState(mu=zeros(), nu=zeros(), count=torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(params, grads, state: AdamState, learning_rate: float):
    """One optax.adam step on `params` (a dict of leaf tensors) and `state`,
    both in place, with `grads` keyed as `params`.  optax's order:
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count + 1, then
    p + (-lr) (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps).
    Only device operations: the compiled step replays it inside its CUDA
    graph, and the eager step runs the same operations."""
    with torch.no_grad():
        state.count.add_(1)
        bc1 = 1.0 - torch.pow(B1, state.count)
        bc2 = 1.0 - torch.pow(B2, state.count)
        for k, p in params.items():
            g = grads[k]
            mu = state.mu[k].copy_((1.0 - B1) * g + B1 * state.mu[k])
            nu = state.nu[k].copy_((1.0 - B2) * (g * g) + B2 * state.nu[k])
            p.add_(-learning_rate * ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS)))


def _step(camera, cfg: InverseConfig, params, opt: AdamState, scene, sky_tex, target,
          sample_offset):
    """The training step's work: render, L2 loss, its gradients (outputs of
    ``torch.autograd.grad``; no ``.grad`` is set) and the Adam update of
    params and opt in place.  Returns the loss before the update."""
    mat = {k: v for k, v in params.items() if k != "sky"}
    scene = scene.with_material_params({**scene.material_params(), **mat})
    rad = render_for_loss(scene, camera, params.get("sky", sky_tex), cfg, sample_offset)
    loss = torch.mean((rad - target) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    adam_update(params, dict(zip(params, grads)), opt, cfg.learning_rate)
    return loss.detach()


def _offset(cfg: InverseConfig, step):
    return 0 if cfg.fixed_samples else step * cfg.spp


def make_train_step(camera, cfg: InverseConfig, *, eager: bool = False):
    """Single-device train step, the counterpart of JAX
    `inverse.py:65-88`.

    Returns (init, train_step): `init(scene, sky_tex)` gives (params,
    opt), where params is a dict of leaf tensors (cfg.fields, plus "sky"
    with cfg.optimize_sky) and opt their :class:`AdamState`;
    `train_step(params, opt, scene, sky_tex, target, step)` updates both
    in place and returns (params, opt, loss), the loss of the parameters
    before the update.  `target` is f32[H*W, 3] flat radiance; `step` an
    int (the samples start at step * spp unless cfg.fixed_samples).

    On the card train_step is compiled, as JAX jits it: one CUDA graph of
    the whole step (:func:`train_step_graphed`), captured on the first
    call and replayed after, bitwise the eager step's work; its graphs
    are ``train_step.graphs`` (``.clear()`` frees them).  On the CPU, and
    with `eager`, it is the eager step, one PyTorch operation at a time
    (the form to debug with on the card).
    """
    graphs = GraphedCall(max_entries=2)

    def train_step(params, opt, scene, sky_tex, target, step):
        if eager or scene.device.type == "cpu":
            loss = _step(camera, cfg, params, opt, scene, sky_tex, target, _offset(cfg, step))
            return params, opt, loss
        return train_step_graphed(graphs, camera, cfg, params, opt, scene, sky_tex, target, step)

    def init(scene, sky_tex):
        params = _leaf_params(scene, cfg)
        if cfg.optimize_sky:
            params["sky"] = sky_tex.detach().clone().requires_grad_(True)
        return params, adam_init(params)

    train_step.graphs = graphs
    return init, train_step


def train_key(camera, cfg: InverseConfig, params, opt, scene, sky_tex, target):
    """The cache key of the compiled train step's graph: every input's
    shape and dtype, the config and the POCA_* switches that choose the
    route."""
    inputs = (params, opt, scene, sky_tex, target, camera)
    return ("train", signature(inputs), dataclasses.astuple(cfg), env_switches())


def train_step_graphed(runner: GraphedCall, camera, cfg: InverseConfig, params, opt, scene,
                       sky_tex, target, step):
    """The compiled train step on the graphs of `runner` (its capture
    backend decides what a capture is): the caller's parameters, Adam
    state, scene, sky, target and camera are copied into the graph's
    buffers, the sample offset is written into its key buffer, the graph
    replays, and the updated parameters and state are copied back into the
    caller's tensors.  Returns (params, opt, loss)."""
    key = train_key(camera, cfg, params, opt, scene, sky_tex, target)
    inputs = (scene, sky_tex, target, camera)
    e = runner.entry(key, lambda r: _capture_train(r, cfg, params, opt, inputs))
    copy_into((e.params, e.opt, e.inputs), (params, opt, inputs))
    e.key.fill_(_offset(cfg, step))
    e.graphs[0].replay()
    copy_into((params, opt), (e.params, e.opt))
    return params, opt, e.loss.clone()


def _capture_train(runner, cfg: InverseConfig, params, opt, inputs):
    """The entry of one train key: static parameters (leaves), Adam state,
    scene, sky, target and camera, the sample-key buffer, and the graph of
    :func:`_step` on them.  Warm-up and capture step the static buffers
    only; every replay starts from the caller's values."""
    e = Entry()
    e.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    e.opt = static_twin(opt)
    e.inputs = static_twin(inputs)
    scene, sky_tex, target, cam = e.inputs
    dev = scene.device
    e.key = torch.zeros((), dtype=torch.int32, device=dev)

    def body():
        e.loss = _step(cam, cfg, e.params, e.opt, scene, sky_tex, target, e.key)

    e.graphs = runner.capture(body, device=dev)
    return e


def _leaf_params(scene, cfg: InverseConfig):
    full = scene.material_params()
    return {k: full[k].detach().clone().requires_grad_(True) for k in cfg.fields}


def fit(scene, camera, sky_tex, target, cfg: InverseConfig, steps: int = 100, callback=None):
    """Run the optimization loop (on the card through the compiled step);
    `callback(step, loss, params)` after each step.  Returns
    (optimized_scene, losses)."""
    init, train_step = make_train_step(camera, cfg)
    params, opt = init(scene, sky_tex)
    target = torch.as_tensor(target, dtype=torch.float32, device=scene.device).reshape(-1, 3)
    losses = []
    try:
        for step in range(steps):
            params, opt, loss = train_step(params, opt, scene, sky_tex, target, step)
            losses.append(float(loss))
            if callback is not None:
                callback(step, losses[-1], params)
    finally:
        train_step.graphs.clear()
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
        for p in params.values():
            p.grad = None
        loss = loss_fn(params, scene, camera, sky_tex, pix, target)
        loss.backward()
        loss = loss.detach()
        if world()[0] > 1:
            dist.all_reduce(loss)
            for p in params.values():
                dist.all_reduce(p.grad)
        adam_update(params, {k: p.grad for k, p in params.items()}, opt, cfg.learning_rate)
        return params, opt, loss

    def init(scene, target_image):
        params = _leaf_params(scene, cfg)
        lo, hi = process_rows(camera.height)
        pix = global_pixel_grid(camera, mesh, (lo, hi))
        h, w = camera.height, camera.width
        image = torch.as_tensor(target_image, dtype=torch.float32).reshape(h, w, 3)
        tgt = torch.zeros((*pix.shape, 3), dtype=torch.float32, device=pix.device)
        tgt[:hi - lo, :w] = image[lo:hi].to(pix.device)
        return params, adam_init(params), pix, tgt

    return init, train_step
