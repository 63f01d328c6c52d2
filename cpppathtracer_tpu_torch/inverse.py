"""Inverse rendering: fit material (and optionally sky) parameters to a
target image by gradient descent through the differentiable render
(counterpart of ``cpppathtracer_tpu/inverse.py``).

The train step is render -> L2 loss -> gradients -> optimizer update.
An optimizer is an :class:`Optimizer`, the counterpart of an optax
``GradientTransformation``: an ``(init, update)`` pair of device-only
tensor operations that update the parameters and the state in place.
:func:`adam` (the default, as JAX's) is optax.adam's update in optax's
order (:func:`adam_update`; betas 0.9 / 0.999, eps 1e-8 added to the root
of the second moment) on explicit state tensors (:class:`AdamState`);
:func:`sgd` is optax.sgd's.  The parameters are JAX's tree: for the
single-device step ``{"mat": {field: leaf}}``, plus ``"sky"`` with
cfg.optimize_sky; for the sharded step the flat ``{field: leaf}``.  On the
card :func:`make_train_step`'s step is one CUDA graph
(``utils/graphs.py``), the counterpart of JAX's jitted ``train_step``; the
eager step runs the same operations.  :func:`make_sharded_train_step` is
the step over a pixel-tile mesh (``parallel/render.py``), compiled on the
card too: a graph for each device of the mesh and a few on its first.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import NamedTuple

import torch
import torch.distributed as dist

from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.parallel.distributed import process_rows, world
from cpppathtracer_tpu_torch.parallel.render import (
    capture_sharded_grad,
    global_pixel_grid,
    make_sharded_loss,
    replay_sharded_grad,
    sharded_grad_key,
)
from cpppathtracer_tpu_torch.utils import obs
from cpppathtracer_tpu_torch.utils.graphs import (
    Entry,
    GraphedCall,
    copy_into,
    env_switches,
    map_tensors,
    signature,
    static_twin,
    tensors,
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


class Optimizer(NamedTuple):
    """The counterpart of an optax ``GradientTransformation``:
    ``init(params) -> state`` and ``update(params, grads, state)``, which
    updates params and state in place (grads in params' tree).  Both are
    device-only tensor operations, with every value they keep a tensor on
    the parameters' device (no host counter, no ``.item()``), so that the
    compiled step captures ``update`` in its CUDA graph."""

    init: Callable
    update: Callable


@dataclasses.dataclass
class AdamState:
    """optax.adam's state (``ScaleByAdamState``): the first and second
    moments of each parameter, in the parameters' tree, and the step
    count, an i32 0-dim tensor on their device."""

    mu: dict
    nu: dict
    count: torch.Tensor


# optax.adam's defaults: eps outside the root, eps_root 0
B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_init(params) -> AdamState:
    """optax.adam's init: zero moments and a zero count."""
    dev = tensors(params)[0].device
    zeros = lambda: map_tensors(params, lambda v: torch.zeros_like(v.detach()))
    return AdamState(mu=zeros(), nu=zeros(), count=torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(params, grads, state: AdamState, learning_rate: float):
    """One optax.adam step on `params` (a tree of leaf tensors) and
    `state`, both in place, with `grads` in the tree of `params`.  optax's
    order: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count + 1,
    then p + (-lr) (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps).
    Only device operations: the compiled step replays it inside its CUDA
    graph, and the eager step runs the same operations."""
    with torch.no_grad():
        state.count.add_(1)
        bc1 = 1.0 - torch.pow(B1, state.count)
        bc2 = 1.0 - torch.pow(B2, state.count)
        for p, g, m, v in zip(tensors(params), tensors(grads), tensors(state.mu),
                              tensors(state.nu), strict=True):
            mu = m.copy_((1.0 - B1) * g + B1 * m)
            nu = v.copy_((1.0 - B2) * (g * g) + B2 * v)
            p.add_(-learning_rate * ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS)))


def adam(learning_rate: float) -> Optimizer:
    """optax.adam(learning_rate) with optax's defaults: :func:`adam_init`
    and :func:`adam_update`."""
    return Optimizer(adam_init, lambda params, grads, state: adam_update(params, grads, state,
                                                                         learning_rate))


def sgd(learning_rate: float) -> Optimizer:
    """optax.sgd(learning_rate) (no momentum): p + (-lr) g, with no state
    (an empty tuple)."""

    def update(params, grads, state):
        with torch.no_grad():
            for p, g in zip(tensors(params), tensors(grads), strict=True):
                p.add_(-learning_rate * g)

    return Optimizer(lambda params: (), update)


def _step(camera, cfg: InverseConfig, optimizer: Optimizer, params, opt, scene, sky_tex,
          target, sample_offset):
    """The training step's work: render, L2 loss, its gradients (outputs of
    ``torch.autograd.grad``; no ``.grad`` is set) and the optimizer's
    update of params ({"mat": ..., "sky"?}) and opt in place.  Returns the
    loss before the update."""
    scene = scene.with_material_params({**scene.material_params(), **params["mat"]})
    rad = render_for_loss(scene, camera, params.get("sky", sky_tex), cfg, sample_offset)
    loss = torch.mean((rad - target) ** 2)
    grads = iter(torch.autograd.grad(loss, tensors(params)))
    optimizer.update(params, map_tensors(params, lambda _: next(grads)), opt)
    return loss.detach()


def _offset(cfg: InverseConfig, step):
    return 0 if cfg.fixed_samples else step * cfg.spp


def make_train_step(camera, cfg: InverseConfig, optimizer: Optimizer | None = None, *,
                    eager: bool = False):
    """Single-device train step, the counterpart of JAX
    `inverse.py:63-88`.

    Returns (init, train_step): `init(scene, sky_tex)` gives (params,
    opt), where params is JAX's tree of leaf tensors, ``{"mat":
    {field: leaf for field in cfg.fields}}`` plus ``"sky"`` with
    cfg.optimize_sky, and opt the optimizer's state (`optimizer`, an
    :class:`Optimizer`, default ``adam(cfg.learning_rate)``);
    `train_step(params, opt, scene, sky_tex, target, step)` updates both
    in place and returns (params, opt, loss), the loss of the parameters
    before the update.  `target` is f32[H*W, 3] flat radiance; `step` an
    int (the samples start at step * spp unless cfg.fixed_samples).

    On the card train_step is compiled, as JAX jits it: one CUDA graph of
    the whole step, the optimizer's update included
    (:func:`train_step_graphed`), captured on the first call and replayed
    after, bitwise the eager step's work; its graphs are
    ``train_step.graphs`` (``.clear()`` frees them).  On the CPU, and
    with `eager`, it is the eager step, one PyTorch operation at a time
    (the form to debug with on the card).
    """
    optimizer = optimizer or adam(cfg.learning_rate)
    graphs = GraphedCall(max_entries=2)

    def train_step(params, opt, scene, sky_tex, target, step):
        if eager or scene.device.type == "cpu":
            loss = _step(camera, cfg, optimizer, params, opt, scene, sky_tex, target,
                         _offset(cfg, step))
            return params, opt, loss
        return train_step_graphed(graphs, camera, cfg, params, opt, scene, sky_tex, target, step,
                                  optimizer)

    def init(scene, sky_tex):
        params = {"mat": _leaf_params(scene, cfg)}
        if cfg.optimize_sky:
            params["sky"] = sky_tex.detach().clone().requires_grad_(True)
        return params, optimizer.init(params)

    train_step.graphs = graphs
    return init, train_step


def train_key(camera, cfg: InverseConfig, params, opt, scene, sky_tex, target):
    """The cache key of the compiled train step's graph: every input's
    shape and dtype, the config and the POCA_* switches that choose the
    route."""
    inputs = (params, opt, scene, sky_tex, target, camera)
    return ("train", signature(inputs), dataclasses.astuple(cfg), env_switches())


def train_step_graphed(runner: GraphedCall, camera, cfg: InverseConfig, params, opt, scene,
                       sky_tex, target, step, optimizer: Optimizer | None = None):
    """The compiled train step on the graphs of `runner` (its capture
    backend decides what a capture is): the caller's parameters, optimizer
    state, scene, sky, target and camera are copied into the graph's
    buffers, the sample offset is written into its key buffer, the graph
    replays, and the updated parameters and state are copied back into the
    caller's tensors.  `optimizer` defaults to ``adam(cfg.learning_rate)``;
    a runner's entries take one optimizer (the key does not name it).
    Returns (params, opt, loss)."""
    optimizer = optimizer or adam(cfg.learning_rate)
    with obs.span("train.step"):
        inputs = (scene, sky_tex, target, camera)
        e = runner.entry(lambda: train_key(camera, cfg, params, opt, scene, sky_tex, target),
                         lambda r: _capture_train(r, cfg, optimizer, params, opt, inputs))
        with obs.span("graphs.copy_in") as sp:
            copy_into((e.params, e.opt, e.inputs), (params, opt, inputs), sp)
            e.key.fill_(_offset(cfg, step))
        e.graphs[0].replay()
        copy_into((params, opt), (e.params, e.opt))
        return params, opt, e.loss.clone()


def _capture_train(runner, cfg: InverseConfig, optimizer: Optimizer, params, opt, inputs):
    """The entry of one train key: static parameters (leaves), optimizer
    state, scene, sky, target and camera, the sample-key buffer, and the
    graph of :func:`_step` on them (the scene's seed, cfg.seed, a device
    fill inside it).  Warm-up and capture step the static buffers only;
    every replay starts from the caller's values."""
    e = Entry()
    e.params = map_tensors(params, lambda v: v.detach().clone().requires_grad_(True))
    e.opt = static_twin(opt)
    e.inputs = static_twin(inputs)
    scene, sky_tex, target, cam = e.inputs
    dev = scene.device
    e.key = torch.zeros((), dtype=torch.int32, device=dev)

    def body():
        e.loss = _step(cam, cfg, optimizer, e.params, e.opt, scene, sky_tex, target, e.key)

    e.graphs = runner.capture(body, device=dev)
    return e


def _leaf_params(scene, cfg: InverseConfig):
    full = scene.material_params()
    return {k: full[k].detach().clone().requires_grad_(True) for k in cfg.fields}


def fit(scene, camera, sky_tex, target, cfg: InverseConfig, steps: int = 100,
        optimizer: Optimizer | None = None, callback=None):
    """Run the optimization loop (on the card through the compiled step)
    with `optimizer` (default ``adam(cfg.learning_rate)``);
    `callback(step, loss, params)` after each step, params JAX's tree
    (``params["mat"]["kd"]``).  Returns (optimized_scene, losses)."""
    init, train_step = make_train_step(camera, cfg, optimizer)
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
    mat = {k: v.detach() for k, v in params["mat"].items()}
    return scene.with_material_params({**scene.material_params(), **mat}), losses


def make_sharded_train_step(mesh, camera, cfg: InverseConfig, optimizer: Optimizer | None = None,
                            *, eager: bool = False):
    """The train step over a pixel-tile mesh, the counterpart of JAX
    `inverse.py:111-140`: the tiles' loss
    (``parallel.render.make_sharded_loss``), its backward, and the
    optimizer's update (default ``adam(cfg.learning_rate)``) of parameters
    and optimizer state that every process holds whole.

    Returns (init, train_step): `init(scene, target_image)` gives (params,
    opt, pix, target), params the flat ``{field: leaf}`` dict of
    cfg.fields (as JAX's sharded step keeps them), pix the global pixel
    grid of this process's rows and target those rows of the f32[H*W, 3]
    (or [H, W, 3]) image, both padded to the mesh tiling;
    `train_step(params, opt, scene, sky_tex, pix, target)` updates params
    and opt in place and returns (params, opt, loss), the loss of the
    parameters before the update, and leaves each parameter's ``.grad``
    set to its gradient.  The samples are cfg.seed's, the same every step
    (JAX's sharded loss takes no sample offset).  With a
    ``torch.distributed`` group of more than one process each process
    renders its own rows, and the loss and the parameter gradients are
    all-reduced before the update, so every process takes the same step.

    On the card train_step is compiled, as JAX jits it
    (:func:`sharded_train_step_graphed`): the graphs of the sharded value
    and gradients (``parallel.render.capture_sharded_grad``, one for each
    distinct device of the mesh and two on its first device) and one more
    of the optimizer's update, captured on the first call and replayed
    after; its graphs are ``train_step.graphs`` (``.clear()`` frees them).
    On the CPU, and with `eager`, it is the eager step.
    """
    optimizer = optimizer or adam(cfg.learning_rate)
    loss_fn = make_sharded_loss(mesh, cfg.spp, cfg.max_depth, cfg.seed)
    graphs = GraphedCall(max_entries=2)

    def train_step(params, opt, scene, sky_tex, pix, target):
        if not (eager or scene.device.type == "cpu"):
            return sharded_train_step_graphed(graphs, mesh, camera, cfg, params, opt, scene,
                                              sky_tex, pix, target, optimizer)
        for p in params.values():
            p.grad = None
        loss = loss_fn(params, scene, camera, sky_tex, pix, target)
        loss.backward()
        loss = loss.detach()
        if world()[0] > 1:
            dist.all_reduce(loss)
            for p in params.values():
                dist.all_reduce(p.grad)
        optimizer.update(params, {k: p.grad for k, p in params.items()}, opt)
        return params, opt, loss

    def init(scene, target_image):
        params = _leaf_params(scene, cfg)
        lo, hi = process_rows(camera.height)
        pix = global_pixel_grid(camera, mesh, (lo, hi))
        h, w = camera.height, camera.width
        image = torch.as_tensor(target_image, dtype=torch.float32).reshape(h, w, 3)
        tgt = torch.zeros((*pix.shape, 3), dtype=torch.float32, device=pix.device)
        tgt[:hi - lo, :w] = image[lo:hi].to(pix.device)
        return params, optimizer.init(params), pix, tgt

    train_step.graphs = graphs
    return init, train_step


def sharded_train_key(mesh, camera, cfg: InverseConfig, params, opt, scene, sky_tex, pix,
                      target):
    """The cache key of the compiled sharded train step: the sharded value
    and gradients' key (``parallel.render.sharded_grad_key``), the
    optimizer state's shapes and the config."""
    inputs = (scene, camera, sky_tex, pix, target)
    return sharded_grad_key(mesh, cfg.spp, cfg.max_depth, cfg.seed, params, inputs) + (
        "train", signature(opt), dataclasses.astuple(cfg))


def sharded_train_step_graphed(runner: GraphedCall, mesh, camera, cfg: InverseConfig, params,
                               opt, scene, sky_tex, pix, target,
                               optimizer: Optimizer | None = None):
    """The compiled sharded train step on the graphs of `runner` (its
    capture backend decides what a capture is): the caller's values are
    copied into the graphs' buffers, the sharded value and gradients
    replay (``parallel.render.replay_sharded_grad``), the loss and the
    gradients are all-reduced between the replays in a group of several
    processes, the update's graph replays on the mesh's first device, and
    the updated parameters and state are copied back into the caller's
    tensors, each ``.grad`` set to a copy of its gradient.  `optimizer`
    defaults to ``adam(cfg.learning_rate)``; a runner's entries take one
    optimizer (the key does not name it).  Returns (params, opt, loss).

    The collectives run between the replays, not inside a graph: they are
    a few calls a step whatever the mesh (n, the loss and one per field),
    and so the one code path serves NCCL on the cards and gloo, which
    cannot be captured, on the CPU."""
    optimizer = optimizer or adam(cfg.learning_rate)
    with obs.span("mesh.step"):
        inputs = (scene, camera, sky_tex, pix, target)
        e = runner.entry(
            lambda: sharded_train_key(mesh, camera, cfg, params, opt, scene, sky_tex, pix, target),
            lambda r: _capture_sharded_train(r, mesh, cfg, optimizer, params, opt, inputs))
        with obs.span("graphs.copy_in") as sp:
            copy_into(e.opt, opt, sp)
        replay_sharded_grad(e, params, inputs)
        if world()[0] > 1:
            with obs.span("mesh.exchange") as sp:
                for t in (e.loss, *e.grads.values()):
                    dist.all_reduce(t)
                    sp.count("bytes", t.nbytes)
        e.update.replay()
        copy_into((params, opt), (e.params[e.first], e.opt))
        for k, p in params.items():
            p.grad = e.grads[k].clone()
        return params, opt, e.loss.clone()


def _capture_sharded_train(runner, mesh, cfg: InverseConfig, optimizer: Optimizer, params, opt,
                           inputs):
    """The entry of one sharded train key: the sharded value and
    gradients' entry, the static optimizer state, and the graph of the
    optimizer's update of the first device's static parameters by the
    summed gradients.  Warm-up and capture step the static buffers only;
    every replay starts from the caller's values."""
    e = capture_sharded_grad(runner, mesh, cfg.spp, cfg.max_depth, cfg.seed, params, inputs)
    e.opt = static_twin(opt)

    def update():
        optimizer.update(e.params[e.first], e.grads, e.opt)

    (e.update,) = runner.capture(update, device=e.first)
    return e
