"""The compiled serving calls on the CPU: ``render_radiance_jit`` against
``render_radiance`` and JAX's ``render_radiance_jit``, and the graph
runner's bookkeeping (``utils/graphs.py``) through a test stand-in for the
capture that runs the body, on every render route and on the progressive
frame.  The captures themselves need a card: ``tests/test_torch_cuda.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpppathtracer_tpu.integrator import render_radiance_jit as j_render_radiance_jit
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.integrator import (
    render_graphed,
    render_key,
    render_radiance,
    render_radiance_jit,
)
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
from cpppathtracer_tpu_torch.models.scene import demo_scene
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.renderer import (
    AccumulatorState,
    ProgressiveRenderer,
    RenderConfig,
    frame_step,
)
from cpppathtracer_tpu_torch.utils.graphs import GraphedCall

from torch_port_helpers import (
    RunBody,
    Replay,
    controlled_scene,
    port_camera,
    port_scene,
    port_sky,
)

torch.set_num_threads(1)


def _demo(w=16, h=12):
    scene = demo_scene(0).build(device="cpu")
    cam = Camera.make(w, h, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device="cpu")
    sky = torch.from_numpy(procedural_sky(16, 16))
    return scene, cam, sky


def _textured(scene):
    """The demo scene with texture 0 on its platform, 1 on its cylinders."""
    rng = np.random.RandomState(3)
    stack = torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    tex_id = torch.where(scene.prim_type == 1, 0, torch.where(scene.prim_type == 2, 1, -1))
    return dataclasses.replace(scene, tex_id=tex_id.to(torch.int32)), stack


def _route(name, monkeypatch):
    """(scene, camera, sky, render kwargs) of a route render_radiance takes."""
    for k in ("POCA_MEGA", "POCA_PLANAR", "POCA_BVH", "POCA_SPP_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    scene, cam, sky = _demo()
    kw = {}
    if name == "textured":
        scene, kw["tex_stack"] = _textured(scene)
    elif name == "wavefront":
        monkeypatch.setenv("POCA_MEGA", "0")
    elif name == "rowmajor":
        monkeypatch.setenv("POCA_MEGA", "0")
        monkeypatch.setenv("POCA_PLANAR", "0")
    elif name == "bvh":
        scene = big_scene(96, bvh=True, device="cpu")
        cam = big_camera(96, 16, 12, device="cpu")
    elif name == "chunked":
        kw["spp_chunk"] = 2
    elif name == "pixels":
        kw["pixel_idx"] = torch.arange(40, 120, dtype=torch.int32)
    return scene, cam, sky, kw


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


ROUTES = ["megakernel", "textured", "wavefront", "rowmajor", "bvh", "chunked", "pixels"]


def test_render_radiance_jit_on_cpu_is_render_radiance():
    """On the CPU the compiled call is the eager one, bit for bit."""
    scene, cam, sky = _demo()
    kw = dict(spp=3, max_depth=3, seed=5, sample_offset=2)
    assert _same(render_radiance_jit(scene, cam, sky, **kw), render_radiance(scene, cam, sky, **kw))


def test_render_radiance_jit_matches_jax(monkeypatch):
    """The port's render_radiance_jit against JAX's on the controlled scene
    at 16x12, 2 spp, depth 4, with the tolerances of
    tests/test_torch_render.py::test_render_controlled_scene_matches_jax."""
    monkeypatch.setenv("POCA_MEGA", "1")
    jcam = JCamera.make(16, 12, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))
    jscene, sky = controlled_scene(), procedural_sky(16, 16)
    ref = [np.asarray(a) for a in j_render_radiance_jit(jscene, jcam, jnp.asarray(sky), 2, 4, 0)]
    got = [a.numpy() for a in render_radiance_jit(port_scene(jscene), port_camera(jcam),
                                                  port_sky(sky), spp=2, max_depth=4, seed=0)]
    close = np.isclose(got[0], ref[0], rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=5e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_graphed_render_bitwise_on_every_route(monkeypatch, route):
    """The graph bodies (first chunk, later chunks, the key advanced
    between them) give render_radiance's bits on each route, at two
    sample offsets through one capture."""
    scene, cam, sky, kw = _route(route, monkeypatch)
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    for offset in (0, 7):
        args = dict(spp=4, max_depth=3, seed=1, sample_offset=offset, **kw)
        got = render_graphed(runner, scene, cam, sky, **args)
        assert _same(got, render_radiance(scene, cam, sky, **args))
    n_chunks = 4 // kw.get("spp_chunk", 1)
    assert runner.captures == backend.captured == 2
    assert backend.replays == 2 * n_chunks


def test_graphed_render_copies_inputs_and_never_recaptures():
    """A moved camera, an in-place edit of kd, a new sky and another
    sample offset are copied into the graph's buffers: the same capture
    replays and gives the eager bits; the key buffer ends advanced by the
    samples the graph traced."""
    scene, cam, sky = _demo()
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    kw = dict(spp=2, max_depth=3, seed=0)
    render_graphed(runner, scene, cam, sky, **kw)
    entry = runner._entries[runner.keys()[0]][0]
    moved = cam.move_forward(0.5)
    scene.kd.mul_(0.5)
    sky2 = sky.flip(0).contiguous()
    for args in ((scene, moved, sky), (scene, moved, sky2)):
        got = render_graphed(runner, *args, sample_offset=3, **kw)
        assert _same(got, render_radiance(*args, sample_offset=3, **kw))
    assert int(entry.key) == 3 + 2
    assert torch.equal(entry.inputs[0].kd, scene.kd) and torch.equal(entry.inputs[2], sky2)
    assert runner.captures == backend.captured == 2 and len(runner.keys()) == 1


def test_capture_runs_on_the_inputs_device():
    """The render's and the progressive frame's warm-ups and captures are
    made on the device of the scene's tensors (on the card: the device
    whose streams the kernel wrappers launch on, which need not be the
    current one)."""
    scene, cam, sky = _demo(12, 8)
    backend = RunBody()
    render_graphed(GraphedCall(backend=backend), scene, cam, sky, spp=2, max_depth=2)
    r = ProgressiveRenderer(scene, cam, sky, RenderConfig(width=12, height=8, max_depth=2))
    r.graphs = GraphedCall(backend=backend)
    r.step_graphed()
    assert backend.devices == {scene.device} and backend.captured == 3


def test_graph_adds_captured_launches_per_replay():
    """The launches a body's wrappers counted while it was captured are
    taken back (nothing ran) and added at every replay; the warm-up's
    stay (it ran)."""
    kb.reset_launches()
    runner = GraphedCall(backend=RunBody())

    def body():
        kb.LAUNCHES["mega_trace"] += 2
        kb.LAUNCHES["denoise"] += 1

    (g,) = runner.capture(body, device=torch.device("cpu"))
    assert kb.LAUNCHES["mega_trace"] == 2 and kb.LAUNCHES["denoise"] == 1
    assert g.launches == {"mega_trace": 2, "denoise": 1}
    for _ in range(3):
        g.replay()
    assert kb.LAUNCHES["mega_trace"] == 8 and kb.LAUNCHES["denoise"] == 4
    kb.reset_launches()


def test_render_key_changes_with_static_arguments_only(monkeypatch):
    """The key changes with resolution, route, spp and depth; not with
    camera, material or sky values, nor with the seed, which render_key no
    longer takes (a replay writes it into the graph's seed buffer, as JAX
    traces it; tests/test_torch_seed_graphs.py)."""
    for k in ("POCA_MEGA", "POCA_PLANAR", "POCA_BVH", "POCA_SPP_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    scene, cam, sky = _demo()
    kw = dict(spp=2, max_depth=3)
    key = render_key(scene, cam, sky, **kw)
    same = [
        render_key(scene, cam.move_forward(1.0).rotate_left(0.1), sky, **kw),
        render_key(scene.with_material_params({"kd": scene.kd * 0.5}), cam, sky, **kw),
        render_key(scene, cam, sky * 2.0, **kw),
    ]
    assert all(k == key for k in same)
    other = [
        render_key(scene, cam.resize(32, 12), sky, **kw),
        render_key(scene, cam, sky, **dict(kw, spp=4)),
        render_key(scene, cam, sky, **dict(kw, max_depth=4)),
        render_key(scene, cam, sky, **dict(kw, spp_chunk=2)),
        render_key(scene.with_bvh(), cam, sky, **kw),
    ]
    monkeypatch.setenv("POCA_MEGA", "0")
    other.append(render_key(scene, cam, sky, **kw))
    assert all(k != key for k in other)
    assert len(set(other)) == len(other)


def test_graphed_render_refuses_grad_inputs():
    """Under grad mode an input that requires grad raises ValueError
    before anything is captured; under no_grad the same call serves."""
    scene, cam, sky = _demo()
    leaf = scene.with_material_params({"kd": scene.kd.clone().requires_grad_()})
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    with pytest.raises(ValueError, match="require grad"):
        render_graphed(runner, leaf, cam, sky, spp=1, max_depth=2)
    assert backend.captured == 0
    with torch.no_grad():
        got = render_graphed(runner, leaf, cam, sky, spp=1, max_depth=2)
        assert _same(got, render_radiance(scene, cam, sky, spp=1, max_depth=2))


def test_cache_is_bounded_and_clear_releases():
    """Past max_entries the least recently used entry's graphs are
    released; clear() releases the rest."""
    scene, cam, sky = _demo()
    backend = RunBody()
    runner = GraphedCall(max_entries=2, backend=backend)
    for depth in (1, 2, 3):
        render_graphed(runner, scene, cam, sky, spp=1, max_depth=depth)
    assert len(runner.keys()) == 2 and backend.released == 1
    runner.clear()
    assert runner.keys() == [] and backend.released == 3


@pytest.mark.parametrize("denoise", [True, False])
def test_progressive_frame_graph_bitwise(denoise):
    """ProgressiveRenderer's frame graph (through the stand-in) against the
    eager frame_step: every frame's mix bit for bit, across a camera move
    (no recapture) and a resize (one recapture)."""
    scene, cam, sky = _demo(12, 8)
    cfg = RenderConfig(width=12, height=8, max_depth=3, denoise=denoise, seed=2)
    r = ProgressiveRenderer(scene, cam, sky, cfg)
    r.graphs = GraphedCall(backend=RunBody())
    state = AccumulatorState.create(8, 12, "cpu")
    eager_cam = cam
    for k in range(5):
        if k == 3:
            r.move_camera(Camera.move_forward, 0.5)
            eager_cam, state = eager_cam.move_forward(0.5), state.refresh()
        img = r.step_graphed()
        state, ref = frame_step(scene, eager_cam, r.sky_tex, state, cfg.seed, cfg.max_depth,
                                denoise, cfg.spp_per_frame)
        assert torch.equal(img, ref) and torch.equal(r.state.mix, state.mix)
        assert r.state.sample_idx == state.sample_idx
    assert r.graphs.captures == 1
    r.resize(8, 6)
    assert r.step_graphed().shape == (6, 8, 3) and r.graphs.captures == 2


class ForgetsBody(RunBody):
    """A stand-in whose captured graph, like a CUDA graph, holds no
    reference to the Python body it was made from."""

    def capture(self, body, pool, device):
        body()
        self.captured += 1
        return Replay(self, lambda: None)


def test_graph_keeps_the_buffers_its_body_reads():
    """A buffer made outside the capture that only the body's closure
    holds (an index vector, say) lives as long as the graph: a CUDA
    graph replays the addresses it captured."""
    import gc
    import weakref

    runner = GraphedCall(backend=ForgetsBody())

    def make():
        pix = torch.arange(16)
        return lambda: pix.sum(), weakref.ref(pix)

    body, ref = make()
    (graph,) = runner.capture(body, device=torch.device("cpu"))
    del body
    gc.collect()
    assert ref() is not None
    del graph
    gc.collect()
    assert ref() is None
