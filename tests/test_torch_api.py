"""JAX's calls with JAX's keywords on the port, on the CPU: an optimizer for
every training entry point (``inverse.make_train_step``, ``fit``,
``make_sharded_train_step``), held against the JAX package run with
``optax.sgd`` on the same scene; ``init``'s parameter tree with JAX's keys;
``demo_scene(seed, pad_to=...)``; ``skip_bvh_tables`` with JAX's keyword
names."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.inverse import InverseConfig as JInverseConfig
from cpppathtracer_tpu.inverse import fit as j_fit
from cpppathtracer_tpu.inverse import make_sharded_train_step as j_make_sharded_train_step
from cpppathtracer_tpu.inverse import make_train_step as j_make_train_step
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops.bvh import skip_bvh_tables as j_skip_bvh_tables
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu.parallel.mesh import make_tile_mesh as j_make_tile_mesh
from cpppathtracer_tpu_torch.inverse import (
    InverseConfig,
    Optimizer,
    adam,
    fit,
    make_sharded_train_step,
    make_train_step,
    sgd,
    train_step_graphed,
)
from cpppathtracer_tpu_torch.models.scene import demo_scene
from cpppathtracer_tpu_torch.ops.bvh import skip_bvh_tables
from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
from cpppathtracer_tpu_torch.utils.graphs import GraphedCall, map_tensors, tensors

from torch_port_helpers import RunBody, controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

LR = 0.5


def _problem():
    """tests/test_torch_inverse.py::test_fit_first_losses_match_jax's
    problem: the controlled scene with every albedo perturbed, a pinhole
    view of 12x8 in which every pixel's path is the same in both packages,
    its target rendered by JAX at 1 spp, depth 2."""
    jcam = JCamera.make(12, 8, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0),
                        view_fov=40.0, lens_radius=0.0)
    sky = procedural_sky(16, 16)
    jscene = controlled_scene()
    target = np.array(j_render_radiance(jscene, jcam, jnp.asarray(sky), spp=1, max_depth=2,
                                        seed=0)[0])
    kd = np.asarray(jscene.kd) + np.random.RandomState(5).uniform(-0.15, 0.15, (5, 3))
    j0 = dataclasses.replace(jscene, kd=jnp.asarray(kd, jnp.float32))
    return j0, jcam, sky, target


def _cfgs(**kw):
    kw = dict(spp=1, max_depth=2, fixed_samples=True, learning_rate=LR, **kw)
    return JInverseConfig(**kw), InverseConfig(**kw)


def test_make_train_step_takes_an_optimizer_as_jax_does():
    """make_train_step(camera, cfg, optimizer=sgd(lr)) against JAX's with
    optax.sgd(lr): three steps' losses and the final albedos and
    emissions within 1e-3 relative (test_torch_inverse.py's bound)."""
    j0, jcam, sky, target = _problem()
    jcfg, cfg = _cfgs(fields=("kd", "emission"))
    scene0 = port_scene(j0)  # before the JAX step, which donates j0's arrays
    j_init, j_step = j_make_train_step(jcam, jcfg, optimizer=optax.sgd(LR))
    j_params, j_opt = j_init(j0, jnp.asarray(sky))
    init, step = make_train_step(port_camera(jcam), cfg, optimizer=sgd(LR))
    params, opt = init(scene0, port_sky(sky))
    tgt = torch.from_numpy(target).reshape(-1, 3)
    for k in range(3):
        j_params, j_opt, j_loss = j_step(j_params, j_opt, j0, jnp.asarray(sky),
                                         jnp.asarray(target).reshape(-1, 3), jnp.int32(k))
        params, opt, loss = step(params, opt, scene0, port_sky(sky), tgt, k)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-3)
    for f in ("kd", "emission"):
        np.testing.assert_allclose(params["mat"][f].detach().numpy(),
                                   np.asarray(j_params["mat"][f]), rtol=1e-3, atol=1e-6)


def test_fit_takes_an_optimizer_and_a_callback_as_jax_does():
    """fit(..., optimizer=sgd(lr), callback=...) against JAX's fit with
    optax.sgd(lr): the callback reads params["mat"]["kd"] at every step in
    both, and the losses and the albedos it saw agree within 1e-3
    relative; the fitted scene holds the last albedos."""
    j0, jcam, sky, target = _problem()
    jcfg, cfg = _cfgs()
    scene0 = port_scene(j0)
    j_seen, seen = [], []
    _, j_losses = j_fit(j0, jcam, jnp.asarray(sky), target, jcfg, 3, optax.sgd(LR),
                        lambda s, loss, p: j_seen.append(np.asarray(p["mat"]["kd"])))
    fitted, losses = fit(scene0, port_camera(jcam), port_sky(sky), torch.from_numpy(target), cfg,
                         steps=3, optimizer=sgd(LR),
                         callback=lambda s, loss, p: seen.append(p["mat"]["kd"].detach().clone()))
    assert losses[2] < losses[0]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    for a, b in zip(seen, j_seen, strict=True):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-6)
    assert torch.equal(fitted.kd, seen[-1])


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_compiled_step_captures_the_optimizer(name):
    """The compiled step's graph (through the stand-in) runs the given
    optimizer's update: three steps bitwise the eager step's, one
    capture."""
    j0, jcam, sky, target = _problem()
    _, cfg = _cfgs(fields=("kd", "emission"), optimize_sky=True)
    scene, cam, psky = port_scene(j0), port_camera(jcam), port_sky(sky)
    tgt = torch.from_numpy(target).reshape(-1, 3)
    optimizer = {"sgd": sgd, "adam": adam}[name](LR)
    init, eager = make_train_step(cam, cfg, optimizer=optimizer)
    p_e, o_e = init(scene, psky)
    p_g, o_g = init(scene, psky)
    runner = GraphedCall(backend=RunBody())
    for k in range(3):
        l_e = eager(p_e, o_e, scene, psky, tgt, k)[2]
        l_g = train_step_graphed(runner, cam, cfg, p_g, o_g, scene, psky, tgt, k, optimizer)[2]
        assert torch.equal(l_e, l_g)
        assert all(torch.equal(a, b) for a, b in zip(tensors(p_e), tensors(p_g)))
    assert runner.captures == 1


def test_init_tree_has_jax_keys():
    """init's parameters: {"mat": {field: leaf}} plus "sky" with
    optimize_sky, as JAX's init returns them; the optimizer's state
    follows the tree (adam) or is empty (sgd)."""
    j0, jcam, sky, _ = _problem()
    scene, cam, psky = port_scene(j0), port_camera(jcam), port_sky(sky)
    for optimize_sky in (False, True):
        jcfg, cfg = _cfgs(fields=("kd", "ior"), optimize_sky=optimize_sky)
        j_params, _ = j_make_train_step(jcam, jcfg)[0](j0, jnp.asarray(sky))
        params, opt = make_train_step(cam, cfg)[0](scene, psky)
        assert list(params) == list(j_params) == ["mat"] + ["sky"] * optimize_sky
        assert list(params["mat"]) == list(j_params["mat"]) == ["kd", "ior"]
        assert all(t.requires_grad and t.is_leaf for t in tensors(params))
        assert list(opt.mu) == list(params) and list(opt.mu["mat"]) == ["kd", "ior"]
        _, sgd_opt = make_train_step(cam, cfg, optimizer=sgd(LR))[0](scene, psky)
        assert sgd_opt == ()
    assert isinstance(sgd(LR), Optimizer) and isinstance(adam(LR), Optimizer)


def test_sharded_train_step_takes_an_optimizer_as_jax_does():
    """make_sharded_train_step(mesh, camera, cfg, optimizer=sgd(lr)) over
    8 tiles against JAX's over its 8 CPU devices with optax.sgd(lr): the
    flat params tree, two steps' losses within 1e-3 relative and the
    albedos after them."""
    from cpppathtracer_tpu.models.scene import SceneBuilder as JSceneBuilder

    b = JSceneBuilder()
    b.add_platform(0.0, kd=(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.3, 0.2))
    jscene = b.build()
    jcam = JCamera.make(16, 12, origin=(0.0, 4.0, -11.0), look_at=(0.0, 2.0, 0.0),
                        view_fov=40.0, lens_radius=0.0)
    sky = procedural_sky(32, 32, seed=4)
    target = np.full((jcam.height * jcam.width, 3), 0.3, np.float32)
    scene = port_scene(jscene)
    jcfg, cfg = _cfgs(fields=("kd",))
    j_init, j_step = j_make_sharded_train_step(j_make_tile_mesh(jax.devices()[:8]), jcam, jcfg,
                                               optimizer=optax.sgd(LR))
    j_params, j_opt, j_pix, j_tgt = j_init(jscene, target)
    init, step = make_sharded_train_step(make_tile_mesh(["cpu"] * 8), port_camera(jcam), cfg,
                                         optimizer=sgd(LR))
    params, opt, pix, tgt = init(scene, target)
    assert list(params) == list(j_params) == ["kd"] and opt == ()
    for _ in range(2):
        j_params, j_opt, j_loss = j_step(j_params, j_opt, jscene, jnp.asarray(sky), j_pix, j_tgt)
        params, opt, loss = step(params, opt, scene, port_sky(sky), pix, tgt)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-3)
    np.testing.assert_allclose(params["kd"].detach().numpy(), np.asarray(j_params["kd"]),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("pad_to", [None, 96, 128])
def test_demo_scene_takes_pad_to_as_jax_does(pad_to):
    """demo_scene(0, pad_to=...) is demo_scene(0), as in the JAX package,
    whose demo_scene ignores pad_to: the same objects as JAX's."""
    got = demo_scene(0, pad_to=pad_to).build(device="cpu")
    ref = demo_scene(0).build(device="cpu")
    jref = j_demo_scene(0, pad_to=pad_to).build()
    for f in ("prim_type", "center", "radius", "kd", "mat_type"):
        assert torch.equal(getattr(got, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jref, f)))


def test_skip_bvh_tables_takes_jax_keywords():
    """skip_bvh_tables with JAX's keyword names (in another order) equals
    the positional call and JAX's tables."""
    rng = np.random.RandomState(2)
    n = 300
    geom = dict(scene_center=rng.uniform(-50, 50, (n, 3)).astype(np.float32),
                scene_radius=rng.uniform(0.5, 3, n).astype(np.float32),
                scene_y_pos=rng.uniform(-2, 2, n).astype(np.float32),
                scene_height=rng.uniform(0.5, 4, n).astype(np.float32),
                scene_prim_type=np.sort(rng.randint(0, 3, n)).astype(np.int32))
    by_name = skip_bvh_tables(leaf_size=16, **dict(reversed(list(geom.items()))))
    by_place = skip_bvh_tables(*geom.values(), 16)
    ref = j_skip_bvh_tables(leaf_size=16, **geom)
    for k in ("node_aabb", "node_meta", "leaf_objs"):
        np.testing.assert_array_equal(by_name[k], by_place[k])
        np.testing.assert_array_equal(by_name[k], np.asarray(ref[k]))
    assert by_name["leaf_size"] == by_place["leaf_size"] == ref["leaf_size"]
