"""The compiled training steps on the CPU: ``inverse.make_train_step``'s
graph (``train_step_graphed``) and ``bench.train_step_jit``'s
(``bench.train_step_graphed``) through the test stand-in for the capture
that runs the body (``torch_port_helpers.RunBody``), against the eager
steps bit for bit on every route ``render_radiance`` takes, the Adam update
against optax's, and the compiled step against JAX's jitted
``make_train_step``.  The captures themselves need a card:
``tests/test_torch_cuda.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.inverse import InverseConfig as JInverseConfig
from cpppathtracer_tpu.inverse import make_train_step as j_make_train_step
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu_torch import bench
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.inverse import (
    AdamState,
    InverseConfig,
    adam_init,
    adam_update,
    fit,
    make_train_step,
    train_key,
    train_step_graphed,
)
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
from cpppathtracer_tpu_torch.models.scene import demo_scene
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.utils.graphs import GraphedCall, map_tensors, tensors

from torch_port_helpers import RunBody, controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

W, H = 16, 12


def _demo():
    scene = demo_scene(0).build(device="cpu")
    cam = Camera.make(W, H, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device="cpu")
    sky = torch.from_numpy(procedural_sky(16, 16))
    return scene, cam, sky


def _textured(scene):
    """The demo scene with texture 0 on its platform, 1 on its cylinders."""
    rng = np.random.RandomState(3)
    stack = torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    tex_id = torch.where(scene.prim_type == 1, 0, torch.where(scene.prim_type == 2, 1, -1))
    return dataclasses.replace(scene, tex_id=tex_id.to(torch.int32)), stack


def _route(name, monkeypatch):
    """(scene, camera, sky, textures) of a training route render_radiance
    takes: the megakernel, the textured megakernel, the wavefront path on
    a BVH scene, route A (the row-major body)."""
    for k in ("POCA_MEGA", "POCA_PLANAR", "POCA_BVH", "POCA_SPP_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    scene, cam, sky = _demo()
    tex = None
    if name == "textured":
        scene, tex = _textured(scene)
    elif name == "bvh":
        scene = big_scene(96, bvh=True, device="cpu")
        cam = big_camera(96, W, H, device="cpu")
    elif name == "rowmajor":
        monkeypatch.setenv("POCA_MEGA", "0")
        monkeypatch.setenv("POCA_PLANAR", "0")
    return scene, cam, sky, tex


def _target(scene, cam, sky):
    """A target rendered from the scene with every albedo moved by a
    seeded perturbation, so that every optimized entry has a gradient."""
    rng = np.random.RandomState(5)
    kd = scene.kd + torch.from_numpy(rng.uniform(-0.15, 0.15, tuple(scene.kd.shape))
                                     .astype(np.float32))
    with torch.no_grad():
        return render_radiance(scene.with_material_params({"kd": kd.clamp(0.0, 1.0)}), cam, sky,
                               spp=2, max_depth=3, seed=0)[0]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_state(a_params, a_opt, b_params, b_opt):
    same = lambda xs, ys: all(torch.equal(_bits(x.detach()), _bits(y.detach()))
                              for x, y in zip(tensors(xs), tensors(ys), strict=True))
    return (same(a_params, b_params) and same(a_opt.mu, b_opt.mu)
            and same(a_opt.nu, b_opt.nu) and torch.equal(a_opt.count, b_opt.count))


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("route", ["megakernel", "bvh", "rowmajor"])
def test_compiled_train_step_bitwise_over_three_steps(monkeypatch, route, fixed):
    """Three compiled steps (one capture, three replays) against three eager
    steps: the loss, the parameters and the Adam state after each step bit
    for bit, with fixed samples and with the sample key advanced by spp a
    step.  The inverse step renders no textures (nor does JAX's), so the
    textured route is held through the bench step below."""
    scene, cam, sky, _ = _route(route, monkeypatch)
    target = _target(scene, cam, sky)
    cfg = InverseConfig(spp=2, max_depth=3, fixed_samples=fixed)
    init, eager = make_train_step(cam, cfg)
    p_e, o_e = init(scene, sky)
    p_g, o_g = init(scene, sky)
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    losses = []
    for step in range(3):
        p_e, o_e, l_e = eager(p_e, o_e, scene, sky, target, step)
        p_g, o_g, l_g = train_step_graphed(runner, cam, cfg, p_g, o_g, scene, sky, target, step)
        assert torch.equal(_bits(l_e), _bits(l_g)), step
        assert _same_state(p_e, o_e, p_g, o_g), step
        losses.append(float(l_e))
    assert int(o_g.count) == 3 and (losses[2] < losses[0] or not fixed)
    assert runner.captures == backend.captured == 1 and backend.replays == 3


def test_capture_takes_no_step():
    """The first call warms the body up and captures it (each runs the body
    on the graph's own buffers) and then replays once: the caller's
    parameters and state are exactly one eager step's."""
    scene, cam, sky = _demo()
    target = _target(scene, cam, sky)
    cfg = InverseConfig(spp=1, max_depth=3, fields=("kd", "emission"))
    init, eager = make_train_step(cam, cfg)
    p_e, o_e = init(scene, sky)
    p_g, o_g = init(scene, sky)
    backend = RunBody()
    p_e, o_e, _ = eager(p_e, o_e, scene, sky, target, 0)
    out = train_step_graphed(GraphedCall(backend=backend), cam, cfg, p_g, o_g, scene, sky,
                             target, 0)
    assert backend.warmups == 1 and backend.captured == 1 and backend.replays == 1
    assert out[0] is p_g and out[1] is o_g
    assert _same_state(p_e, o_e, p_g, o_g) and int(o_g.count) == 1


def test_edited_parameters_are_copied_in_without_recapture():
    """Parameters and Adam state edited between calls (in place and by new
    tensors of the same shapes) and a new target: the graph's buffers take
    them, nothing is captured again, and the caller's own tensors hold the
    update."""
    scene, cam, sky = _demo()
    target = _target(scene, cam, sky)
    cfg = InverseConfig(spp=1, max_depth=3, fields=("kd", "emission"), fixed_samples=True)
    init, eager = make_train_step(cam, cfg)
    p_e, o_e = init(scene, sky)
    p_g, o_g = init(scene, sky)
    runner = GraphedCall(backend=RunBody())
    train_step_graphed(runner, cam, cfg, p_g, o_g, scene, sky, target, 0)
    eager(p_e, o_e, scene, sky, target, 0)
    with torch.no_grad():
        for p in (p_e, p_g):
            p["mat"]["kd"].mul_(0.9)
            p["mat"]["emission"] = p["mat"]["emission"].detach() + 0.25
            p["mat"]["emission"].requires_grad_(True)
        for o in (o_e, o_g):
            o.mu["mat"]["kd"].zero_()
    target2 = target.flip(0).contiguous()
    kd_before = p_g["mat"]["kd"]
    p_e, o_e, l_e = eager(p_e, o_e, scene, sky, target2, 1)
    p_g, o_g, l_g = train_step_graphed(runner, cam, cfg, p_g, o_g, scene, sky, target2, 1)
    assert torch.equal(_bits(l_e), _bits(l_g)) and _same_state(p_e, o_e, p_g, o_g)
    assert p_g["mat"]["kd"] is kd_before and runner.captures == 1 and len(runner.keys()) == 1


def test_train_key_changes_with_config_and_shapes_only(monkeypatch):
    """The key changes with every field of the config, the shapes of
    parameters, scene, sky and target, and the POCA_* switches; not with
    their values."""
    for k in ("POCA_MEGA", "POCA_PLANAR", "POCA_BVH", "POCA_SPP_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    scene, cam, sky = _demo()
    target = torch.zeros((W * H, 3))
    cfg = InverseConfig(spp=1, max_depth=2)
    init, _ = make_train_step(cam, cfg)
    params, opt = init(scene, sky)
    key = train_key(cam, cfg, params, opt, scene, sky, target)
    moved = map_tensors(params, lambda v: v.detach() * 0.5)
    same = [
        train_key(cam.move_forward(1.0), cfg, params, opt, scene, sky, target),
        train_key(cam, cfg, moved, adam_init(moved), scene, sky * 2.0, target + 1.0),
        train_key(cam, cfg, params, opt, scene.with_material_params({"kd": scene.kd * 0.5}),
                  sky, target),
    ]
    assert all(k == key for k in same)
    other = [train_key(cam, dataclasses.replace(cfg, **change), params, opt, scene, sky, target)
             for change in (dict(spp=2), dict(max_depth=3), dict(seed=1), dict(fields=("kd",)),
                            dict(optimize_sky=True), dict(fixed_samples=True),
                            dict(learning_rate=0.1))]
    sky_params = dict(params, sky=sky.clone().requires_grad_())
    other += [
        train_key(cam.resize(8, 6), cfg, params, opt, scene, sky, target[:48]),
        train_key(cam, cfg, params, opt, scene, sky, target[:48]),
        train_key(cam, cfg, params, opt, scene, torch.from_numpy(procedural_sky(8, 8)), target),
        train_key(cam, cfg, sky_params, adam_init(sky_params), scene, sky, target),
        train_key(cam, cfg, params, opt, scene.with_bvh(), sky, target),
    ]
    monkeypatch.setenv("POCA_MEGA", "0")
    other.append(train_key(cam, cfg, params, opt, scene, sky, target))
    assert all(k != key for k in other)
    assert len(set(other)) == len(other)


@pytest.mark.parametrize("route", ["megakernel", "textured", "bvh", "rowmajor"])
def test_compiled_bench_step_is_train_step(monkeypatch, route):
    """bench.train_step_jit's graph body (through the stand-in) against the
    eager bench.train_step: the loss and every gradient (the texture
    stack's on the textured route) bit for bit, twice through one capture,
    the second time after an in-place kd edit."""
    scene, cam, sky, tex = _route(route, monkeypatch)
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    for _ in range(2):
        loss, grads = bench.train_step_graphed(runner, scene, cam, sky, 2, 3, tex)
        ref_loss, ref = bench.train_step(scene, cam, sky, 2, 3, tex_stack=tex)
        assert torch.equal(_bits(loss), _bits(ref_loss))
        assert list(grads) == list(ref) == ["kd", "emission"] + ["tex_stack"] * (tex is not None)
        assert all(torch.equal(_bits(grads[k]), _bits(ref[k])) for k in ref)
        scene.kd.mul_(0.9)
    assert runner.captures == backend.captured == 1 and backend.replays == 2


def test_bench_step_on_cpu_is_eager():
    """On the CPU build_bench's step and train_step_jit are train_step."""
    step, scene, cam, sky = bench.build_bench(W, H, 1, 2, "cpu")
    loss, grads = step()
    ref_loss, ref = bench.train_step(scene, cam, sky, 1, 2)
    assert torch.equal(loss, ref_loss) and all(torch.equal(grads[k], ref[k]) for k in ref)
    assert bench.BENCH_GRAPHS.keys() == []


def test_graph_counts_the_backward_launches():
    """The launches a step's graph counted at capture (on the card the
    forward's and mega_bwd's; the CPU's plain versions count none, so
    they are set here by hand) come back at every replay."""
    scene, cam, sky = _demo()
    runner = GraphedCall(backend=RunBody())
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd",))
    init, _ = make_train_step(cam, cfg)
    params, opt = init(scene, sky)
    target = torch.zeros((W * H, 3))
    train_step_graphed(runner, cam, cfg, params, opt, scene, sky, target, 0)
    (graph,) = runner._entries[runner.keys()[0]][1]
    graph.launches = {"mega_trace": 2, "mega_bwd": 1}
    kb.reset_launches()
    try:
        for step in (1, 2):
            train_step_graphed(runner, cam, cfg, params, opt, scene, sky, target, step)
        assert kb.LAUNCHES["mega_trace"] == 4 and kb.LAUNCHES["mega_bwd"] == 2
    finally:
        kb.reset_launches()


def test_fit_on_cpu_runs_the_eager_step_and_keeps_no_graph():
    """fit on the CPU: the eager step (nothing captured), the same losses
    as the eager step called by hand."""
    scene, cam, sky = _demo()
    target = _target(scene, cam, sky)
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd",), fixed_samples=True)
    _, losses = fit(scene, cam, sky, target, cfg, steps=2)
    init, eager = make_train_step(cam, cfg, eager=True)
    params, opt = init(scene, sky)
    ref = [float(eager(params, opt, scene, sky, target, s)[2]) for s in range(2)]
    assert losses == ref


def test_adam_update_matches_optax():
    """adam_update against optax.adam(lr) over four steps of seeded
    gradients: parameters, moments and count within float32 rounding
    (1e-6 relative)."""
    rng = np.random.RandomState(7)
    shapes = {"kd": (5, 3), "emission": (5,)}
    init = {k: rng.uniform(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in init.items()}
    state = adam_init(params)
    opt = optax.adam(0.05)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = opt.init(j_params)
    for _ in range(4):
        g = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
        adam_update(params, {k: torch.from_numpy(v) for k, v in g.items()}, state, 0.05)
        upd, j_state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
    assert isinstance(state, AdamState) and int(state.count) == int(j_state[0].count) == 4
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(j_params[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(j_state[0].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(j_state[0].nu[k]), rtol=1e-6)


def test_compiled_step_matches_jax_jitted_train_step():
    """The compiled step (through the stand-in) against JAX's jitted
    make_train_step on the controlled scene carried across by convert.py
    (12x8, 1 spp, depth 2, fixed samples, every albedo perturbed, no lens
    jitter; as tests/test_torch_inverse.py::test_fit_first_losses_match_jax):
    after each of three steps the losses and the albedos agree within
    test_torch_inverse.py's rtol of 1e-3."""
    jcam = JCamera.make(12, 8, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0),
                        view_fov=40.0, lens_radius=0.0)
    sky = procedural_sky(16, 16)
    jscene = controlled_scene()
    target = np.asarray(j_render_radiance(jscene, jcam, jnp.asarray(sky), spp=1, max_depth=2,
                                          seed=0)[0])
    kd = np.asarray(jscene.kd) + np.random.RandomState(5).uniform(-0.15, 0.15, (5, 3))
    j0 = dataclasses.replace(jscene, kd=jnp.asarray(kd, jnp.float32))
    scene, cam, psky = port_scene(j0), port_camera(jcam), port_sky(sky)
    j_init, j_step = j_make_train_step(jcam, JInverseConfig(spp=1, max_depth=2, fields=("kd",),
                                                            fixed_samples=True))
    j_params, j_opt = j_init(j0, jnp.asarray(sky))
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd",), fixed_samples=True)
    init, _ = make_train_step(cam, cfg)
    params, opt = init(scene, psky)
    runner = GraphedCall(backend=RunBody())
    tgt = torch.from_numpy(np.array(target))
    for step in range(3):
        j_params, j_opt, j_loss = j_step(j_params, j_opt, j0, jnp.asarray(sky),
                                         jnp.asarray(target), jnp.int32(step))
        params, opt, loss = train_step_graphed(runner, cam, cfg, params, opt, scene, psky, tgt,
                                               step)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-3)
        np.testing.assert_allclose(params["mat"]["kd"].detach().numpy(),
                                   np.asarray(j_params["mat"]["kd"]), rtol=1e-3)
