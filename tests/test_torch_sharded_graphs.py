"""The compiled sharded training step on the CPU: ``inverse.
make_sharded_train_step``'s graphs (``sharded_train_step_graphed``) and
``parallel.render.make_sharded_value_and_grad``'s (``sharded_grad_graphed``)
through the test stand-in for the capture that runs each body
(``torch_port_helpers.RunBody``), against the eager forms bit for bit on
meshes of "cpu" entries, and against JAX's jitted
``make_sharded_train_step``.  The captures themselves need a card:
``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpppathtracer_tpu.inverse import InverseConfig as JInverseConfig
from cpppathtracer_tpu.inverse import make_sharded_train_step as j_make_sharded_train_step
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpppathtracer_tpu.ops.texture import procedural_sky as j_procedural_sky
from cpppathtracer_tpu.parallel.mesh import make_tile_mesh as j_make_tile_mesh
from cpppathtracer_tpu_torch.inverse import (
    InverseConfig,
    make_sharded_train_step,
    sgd,
    sharded_train_key,
    sharded_train_step_graphed,
)
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import SceneBuilder
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
from cpppathtracer_tpu_torch.parallel.render import (
    make_sharded_loss,
    make_sharded_value_and_grad,
    sharded_grad_graphed,
)
from cpppathtracer_tpu_torch.types import MaterialType
from cpppathtracer_tpu_torch.utils.graphs import GraphedCall, tensors

from torch_port_helpers import RunBody, port_camera, port_scene, port_sky

torch.set_num_threads(1)

CPU = "cpu"
FIELDS = ("kd", "emission")
W, H = 20, 14  # pads to 20x16 over 2x4 tiles


def _scene_camera_sky(w=W, h=H):
    """Two diffuse spheres (one emitting) and a metal one on a floor: every
    albedo and emission has a gradient."""
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.85, 0.85, 0.85))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.2, 0.2))
    b.add_sphere((-3.0, 1.0, 2.0), 1.0, mat_type=MaterialType.METAL, kd=(0.9, 0.9, 0.5),
                 smoothness=2.0)
    b.add_sphere((3.0, 1.0, 1.0), 1.0, kd=(0.3, 0.8, 0.4), emission=1.5)
    cam = Camera.make(w, h, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device=CPU)
    return b.build(device=CPU), cam, torch.from_numpy(procedural_sky(16, 16, seed=9))


def _target(cam):
    rng = np.random.RandomState(5)
    return rng.uniform(0.0, 0.6, (cam.height * cam.width, 3)).astype(np.float32)


def _mesh(shape, devices=None):
    return make_tile_mesh(devices or [CPU] * (shape[0] * shape[1]), shape)


def _bits(t):
    t = t.detach()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(tensors(a), tensors(b), strict=True))


def _same_step(pe, oe, le, pg, og, lg):
    """Loss, parameters, optimizer state and every .grad bit for bit."""
    return (torch.equal(_bits(le), _bits(lg)) and _same(pe, pg) and _same(oe, og)
            and _same({k: p.grad for k, p in pe.items()}, {k: p.grad for k, p in pg.items()}))


def _setup(mesh, cfg, optimizer=None, cam_size=(W, H)):
    scene, cam, sky = _scene_camera_sky(*cam_size)
    init, eager = make_sharded_train_step(mesh, cam, cfg, optimizer)
    pe, oe, pix, tgt = init(scene, _target(cam))
    pg, og, _, _ = init(scene, _target(cam))
    return scene, cam, sky, eager, (pe, oe), (pg, og), pix, tgt


@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (2, 4)])
def test_compiled_sharded_train_step_bitwise_over_three_steps(shape, opt_name):
    """Three compiled steps (one capture of each body, three replays)
    against three eager steps over a mesh of "cpu" entries (one distinct
    device, so no float atomics): after each step the loss, the
    parameters, the optimizer state and each .grad bit for bit.  A key
    captures the count, the one device's body, the reduce and the update;
    every later step replays those four."""
    mesh = _mesh(shape)
    cfg = InverseConfig(spp=2, max_depth=3, fields=FIELDS)
    optimizer = sgd(0.5) if opt_name == "sgd" else None
    scene, cam, sky, eager, (pe, oe), (pg, og), pix, tgt = _setup(mesh, cfg, optimizer)
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    losses = []
    for step in range(3):
        pe, oe, le = eager(pe, oe, scene, sky, pix, tgt)
        pg, og, lg = sharded_train_step_graphed(runner, mesh, cam, cfg, pg, og, scene, sky, pix,
                                                tgt, optimizer)
        assert _same_step(pe, oe, le, pg, og, lg), step
        losses.append(float(le))
    assert losses[2] < losses[0]
    assert runner.captures == backend.captured == 4 and backend.replays == 12
    assert len(runner.keys()) == 1


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)])
def test_compiled_sharded_value_and_grad_bitwise(shape):
    """make_sharded_value_and_grad's compiled form (through the stand-in)
    against its eager form and against make_sharded_loss with
    torch.autograd.grad: the loss and each gradient bit for bit, twice
    through one capture, the second time after an in-place kd edit; the
    outputs are the caller's own tensors, not the graphs' buffers."""
    mesh = _mesh(shape)
    scene, cam, sky = _scene_camera_sky()
    init, _ = make_sharded_train_step(mesh, cam, InverseConfig(fields=FIELDS))
    params, _, pix, tgt = init(scene, _target(cam))
    eager = make_sharded_value_and_grad(mesh, 2, 3, eager=True)
    loss_fn = make_sharded_loss(mesh, 2, 3)
    runner = GraphedCall(backend=RunBody())
    outs = []
    for _ in range(2):
        loss, grads = sharded_grad_graphed(runner, mesh, 2, 3, 0, params, scene, cam, sky, pix,
                                           tgt)
        ref_loss, ref = eager(params, scene, cam, sky, pix, tgt)
        by_hand = loss_fn(params, scene, cam, sky, pix, tgt)
        hand = torch.autograd.grad(by_hand, list(params.values()))
        assert list(grads) == list(ref) == list(FIELDS)
        assert torch.equal(_bits(loss), _bits(ref_loss)) and torch.equal(_bits(loss),
                                                                           _bits(by_hand))
        assert all(torch.equal(_bits(grads[k]), _bits(ref[k])) for k in FIELDS)
        assert all(torch.equal(_bits(grads[k]), _bits(h)) for k, h in zip(FIELDS, hand))
        outs.append((loss, grads))
        with torch.no_grad():
            params["kd"].mul_(0.9)
    e = runner[runner.keys()[0]]
    assert outs[0][0] is not e.loss and all(outs[0][1][k] is not e.grads[k] for k in FIELDS)
    assert not torch.equal(outs[0][0], outs[1][0])
    assert runner.captures == 3 and len(runner.keys()) == 1


def test_value_and_grad_on_cpu_is_eager():
    """On the CPU make_sharded_value_and_grad runs the eager loss and
    captures nothing."""
    mesh = _mesh((2, 2))
    scene, cam, sky = _scene_camera_sky()
    init, _ = make_sharded_train_step(mesh, cam, InverseConfig(fields=FIELDS))
    params, _, pix, tgt = init(scene, _target(cam))
    vg = make_sharded_value_and_grad(mesh, 1, 2)
    loss, grads = vg(params, scene, cam, sky, pix, tgt)
    ref_loss, ref = make_sharded_value_and_grad(mesh, 1, 2, eager=True)(params, scene, cam, sky,
                                                                          pix, tgt)
    assert torch.equal(loss, ref_loss) and all(torch.equal(grads[k], ref[k]) for k in FIELDS)
    assert vg.graphs.keys() == [] and vg.graphs.captures == 0


def test_capture_takes_no_step():
    """The first call warms each body up and captures it (each runs the
    body on the graphs' own buffers) and then replays once: the caller's
    parameters, state and .grad are exactly one eager step's."""
    mesh = _mesh((2, 2))
    cfg = InverseConfig(spp=1, max_depth=3, fields=FIELDS)
    scene, cam, sky, eager, (pe, oe), (pg, og), pix, tgt = _setup(mesh, cfg)
    backend = RunBody()
    pe, oe, le = eager(pe, oe, scene, sky, pix, tgt)
    out = sharded_train_step_graphed(GraphedCall(backend=backend), mesh, cam, cfg, pg, og, scene,
                                     sky, pix, tgt)
    assert backend.warmups == 4 and backend.captured == 4 and backend.replays == 4
    assert out[0] is pg and out[1] is og
    assert _same_step(pe, oe, le, pg, og, out[2]) and int(og.count) == 1


def test_one_capture_per_device_and_key():
    """A second step replays without a capture; edited parameters (in place
    and by new tensors), another target and a moved camera replay too; a
    new pixel grid shape (another image size) is a new key and captures
    again; .clear() releases every graph of both keys."""
    mesh = _mesh((2, 2))
    cfg = InverseConfig(spp=1, max_depth=3, fields=FIELDS)
    scene, cam, sky, eager, (pe, oe), (pg, og), pix, tgt = _setup(mesh, cfg)
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    for _ in range(2):
        pe, oe, le = eager(pe, oe, scene, sky, pix, tgt)
        pg, og, lg = sharded_train_step_graphed(runner, mesh, cam, cfg, pg, og, scene, sky, pix,
                                                tgt)
    assert _same_step(pe, oe, le, pg, og, lg) and runner.captures == 4
    with torch.no_grad():
        for p, o in ((pe, oe), (pg, og)):
            p["kd"].mul_(0.9)
            p["emission"] = p["emission"].detach() + 0.25
            p["emission"].requires_grad_(True)
            o.mu["kd"].zero_()
    tgt2 = tgt.flip(0).contiguous()
    moved = cam.move_forward(1.0)
    _, eager2 = make_sharded_train_step(mesh, moved, cfg)
    kd_before = pg["kd"]
    pe, oe, le = eager2(pe, oe, scene, sky, pix, tgt2)
    pg, og, lg = sharded_train_step_graphed(runner, mesh, moved, cfg, pg, og, scene, sky, pix,
                                            tgt2)
    assert _same_step(pe, oe, le, pg, og, lg)
    assert pg["kd"] is kd_before and runner.captures == 4 and len(runner.keys()) == 1
    small = cam.resize(16, 12)
    init3, eager3 = make_sharded_train_step(mesh, small, cfg)
    _, _, pix3, tgt3 = init3(scene, _target(small))
    pe, oe, le = eager3(pe, oe, scene, sky, pix3, tgt3)
    pg, og, lg = sharded_train_step_graphed(runner, mesh, small, cfg, pg, og, scene, sky, pix3,
                                            tgt3)
    assert _same_step(pe, oe, le, pg, og, lg)
    assert runner.captures == 8 and len(runner.keys()) == 2
    runner.clear()
    assert runner.keys() == [] and backend.released == 8


def test_key_changes_with_config_mesh_and_shapes_only(monkeypatch):
    """The key changes with the config, the mesh, the shapes of parameters
    and pixel grid, and the POCA_* switches; not with their values."""
    monkeypatch.delenv("POCA_MEGA", raising=False)
    mesh = _mesh((2, 2))
    cfg = InverseConfig(spp=1, max_depth=2, fields=FIELDS)
    scene, cam, sky, _, (params, opt), _, pix, tgt = _setup(mesh, cfg)
    key = lambda **kw: sharded_train_key(kw.get("mesh", mesh), cam, kw.get("cfg", cfg),
                                         kw.get("params", params), opt, scene, sky,
                                         kw.get("pix", pix), tgt)
    moved = {k: v.detach() * 0.5 for k, v in params.items()}
    assert key() == key(params=moved) == sharded_train_key(mesh, cam.move_forward(1.0), cfg,
                                                           params, opt, scene, sky * 2.0,
                                                           pix.flip(0), tgt + 1.0)
    other = [key(cfg=InverseConfig(spp=2, max_depth=2, fields=FIELDS)),
             key(cfg=InverseConfig(spp=1, max_depth=2, fields=FIELDS, seed=3)),
             key(cfg=InverseConfig(spp=1, max_depth=2, fields=FIELDS, learning_rate=0.1)),
             key(mesh=_mesh((1, 4))), key(mesh=_mesh((2, 2), [CPU, "cpu:0", CPU, "cpu:0"])),
             key(params={"kd": params["kd"]}), key(pix=pix[:8])]
    base = key()
    monkeypatch.setenv("POCA_MEGA", "0")
    other.append(key())
    assert base not in other and len(set(other)) == len(other)


def test_two_distinct_devices_take_a_body_each():
    """A 2x2 mesh over two distinct device entries that are both the CPU
    ("cpu" and "cpu:0"): a body for each, the copies between them, and the
    reduce's sum of their gradients.  The loss bit for bit the eager
    step's (the tile sums are stacked in tile order either way); the
    gradients and parameters to float32 rounding (eager autograd sums the
    tiles' gradients in its own order, the reduce device by device)."""
    mesh = _mesh((2, 2), [CPU, "cpu:0", "cpu:0", CPU])
    assert len(mesh.distinct_devices()) == 2
    cfg = InverseConfig(spp=2, max_depth=3, fields=FIELDS)
    scene, cam, sky, eager, (pe, oe), (pg, og), pix, tgt = _setup(mesh, cfg)
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    for _ in range(2):
        pe, oe, le = eager(pe, oe, scene, sky, pix, tgt)
        pg, og, lg = sharded_train_step_graphed(runner, mesh, cam, cfg, pg, og, scene, sky, pix,
                                                tgt)
        assert torch.equal(_bits(le), _bits(lg))
        for k in FIELDS:
            torch.testing.assert_close(pg[k].grad, pe[k].grad, rtol=1e-5, atol=1e-8)
            torch.testing.assert_close(pg[k].detach(), pe[k].detach(), rtol=1e-5, atol=1e-7)
    assert runner.captures == 5 and backend.devices == {torch.device(CPU), torch.device("cpu:0")}


def test_sharded_step_spans_share_its_call():
    """Under a profiler a compiled step over two distinct devices records
    one `mesh.step` whose call id every span inside it shares: the entry
    (a hit once captured, its key's walk counted), the copies in, the
    exchange across devices (the count's copy and the other device's tiles
    going out, its flat results coming back, their bytes counted) and the
    reduce's replay."""
    from torch.profiler import ProfilerActivity, profile

    from cpppathtracer_tpu_torch.utils import obs

    mesh = _mesh((2, 2), [CPU, "cpu:0", "cpu:0", CPU])
    cfg = InverseConfig(spp=1, max_depth=2, fields=FIELDS)
    scene, cam, sky, _, _, (params, opt), pix, tgt = _setup(mesh, cfg)
    runner = GraphedCall(backend=RunBody())
    sharded_train_step_graphed(runner, mesh, cam, cfg, params, opt, scene, sky, pix, tgt)
    e = runner[runner.keys()[0]]
    obs.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            sharded_train_step_graphed(runner, mesh, cam, cfg, params, opt, scene, sky, pix, tgt)
        recs = obs.spans()
    finally:
        obs.clear_spans()
    assert recs[0]["name"] == "mesh.step" and recs[0]["parent"] == -1
    assert all(r["call"] == recs[0]["call"] and r["parent"] != -1 for r in recs[1:])
    names = [r["name"] for r in recs if r["parent"] == 0]
    assert names == ["graphs.entry", "graphs.copy_in", "graphs.copy_in", "graphs.replay",
                     "mesh.exchange", "graphs.replay", "graphs.replay", "mesh.exchange",
                     "mesh.reduce", "graphs.replay"]
    assert recs[1]["counts"] == {"hit": 1}
    other = torch.device("cpu:0")
    tiles = [t for (dev, _, _), t in zip(e.tiles, e.tile_in) if dev == other]
    assert [r["counts"]["bytes"] for r in recs if r["name"] == "mesh.exchange"] == [
        e.n.nbytes + sum(p.nbytes + t.nbytes for p, t in tiles), e.flat[other].nbytes]
    (reduce,) = [r for r in recs if r["name"] == "mesh.reduce"]
    assert [r["name"] for r in recs if recs[r["parent"]] is reduce] == ["graphs.replay"]
    assert sum(r["name"] == "graphs.replay" for r in recs) == 5


def test_graphs_count_their_launches():
    """The launches each graph counted at capture (on the card the
    forward's and mega_bwd's; the CPU's plain versions count none, so they
    are set here by hand) come back at every replay, summed over the
    device bodies."""
    mesh = _mesh((2, 2), [CPU, "cpu:0", "cpu:0", CPU])
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd",))
    scene, cam, sky, _, _, (params, opt), pix, tgt = _setup(mesh, cfg)
    runner = GraphedCall(backend=RunBody())
    sharded_train_step_graphed(runner, mesh, cam, cfg, params, opt, scene, sky, pix, tgt)
    e = runner[runner.keys()[0]]
    for graph in e.bodies.values():
        graph.launches = {"mega_trace": 4, "stream_compact": 2, "stream_expand": 2,
                          "mega_bwd": 2}
    kb.reset_launches()
    try:
        for _ in range(2):
            sharded_train_step_graphed(runner, mesh, cam, cfg, params, opt, scene, sky, pix, tgt)
        assert (kb.LAUNCHES["mega_trace"], kb.LAUNCHES["stream_compact"],
                kb.LAUNCHES["stream_expand"], kb.LAUNCHES["mega_bwd"]) == (16, 8, 8, 8)
    finally:
        kb.reset_launches()


def test_make_sharded_train_step_on_cpu_is_eager():
    """On the CPU train_step is the eager step, with and without `eager`:
    nothing captured, the same results."""
    mesh = _mesh((1, 2))
    cfg = InverseConfig(spp=1, max_depth=2, fields=FIELDS)
    scene, cam, sky = _scene_camera_sky()
    runs = []
    for eager_form in (False, True):
        init, step = make_sharded_train_step(mesh, cam, cfg, eager=eager_form)
        params, opt, pix, tgt = init(scene, _target(cam))
        params, opt, loss = step(params, opt, scene, sky, pix, tgt)
        runs.append((params, opt, loss))
        assert step.graphs.keys() == [] and step.graphs.captures == 0
    (pa, oa, la), (pb, ob, lb) = runs
    assert _same_step(pa, oa, la, pb, ob, lb)


def test_compiled_step_matches_jax_jitted_sharded_train_step():
    """The compiled sharded step (through the stand-in) over 8 "cpu" tiles
    against JAX's jitted make_sharded_train_step over jax.devices()[:8]
    with Adam, on the scene of tests/test_torch_api.py::
    test_sharded_train_step_takes_an_optimizer_as_jax_does (16x12, 1 spp,
    depth 2): after each of three steps the losses, and the albedos
    after them, within that test's rtol of 1e-3."""
    b = JSceneBuilder()
    b.add_platform(0.0, kd=(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.3, 0.2))
    jscene = b.build()
    jcam = JCamera.make(16, 12, origin=(0.0, 4.0, -11.0), look_at=(0.0, 2.0, 0.0),
                        view_fov=40.0, lens_radius=0.0)
    sky = j_procedural_sky(32, 32, seed=4)
    target = np.full((jcam.height * jcam.width, 3), 0.3, np.float32)
    j_init, j_step = j_make_sharded_train_step(
        j_make_tile_mesh(jax.devices()[:8]), jcam,
        JInverseConfig(spp=1, max_depth=2, fields=("kd",), learning_rate=0.05))
    j_params, j_opt, j_pix, j_tgt = j_init(jscene, target)
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd",), learning_rate=0.05)
    mesh, cam, scene = _mesh((2, 4)), port_camera(jcam), port_scene(jscene)
    init, _ = make_sharded_train_step(mesh, cam, cfg)
    params, opt, pix, tgt = init(scene, target)
    runner = GraphedCall(backend=RunBody())
    for _ in range(3):
        j_params, j_opt, j_loss = j_step(j_params, j_opt, jscene, jnp.asarray(sky), j_pix, j_tgt)
        params, opt, loss = sharded_train_step_graphed(runner, mesh, cam, cfg, params, opt,
                                                       scene, port_sky(sky), pix, tgt)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-3)
        np.testing.assert_allclose(params["kd"].detach().numpy(), np.asarray(j_params["kd"]),
                                   rtol=1e-3, atol=1e-6)
    assert runner.captures == 4
