"""The seed as a device word, and the graphs it lets one capture serve, on
the CPU.

The Pallas megakernel and its backward read the seed from a scalar-prefetch
ref (JAX ``ops/pallas/mega_kernel.py:136``, ``mega_bwd_kernel.py:207``),
and JAX traces it in ``render_radiance_jit`` and the progressive frame.
The port's kernels read it from an i32 word on the device, so its render,
progressive, video and tile graphs replay any seed.  Here: every function
that takes a seed gives the int's bits with the seed as a tensor; one
capture (through the stand-in backend of ``tests/torch_port_helpers.py``)
serves seeds 0, 1 and 2; the compiled video writes the eager loop's PNG
bytes, frame by frame, however many frames are queued; the compiled tiles
are the eager tiles' bits.  The captures themselves need a card:
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cpppathtracer_tpu import video as j_video
from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu_torch import video
from cpppathtracer_tpu_torch.integrator import render_graphed, render_key, render_radiance
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import demo_scene
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd_plain
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T, mega_trace_plain
from cpppathtracer_tpu_torch.ops.fast import group_scene
from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
from cpppathtracer_tpu_torch.parallel.render import render_tiles, tile_graphs
from cpppathtracer_tpu_torch.renderer import (
    AccumulatorState,
    ProgressiveRenderer,
    RenderConfig,
    frame_step,
)
from cpppathtracer_tpu_torch.utils.graphs import GraphedCall
from cpppathtracer_tpu_torch.utils.rng import seed_word

from torch_port_helpers import RunBody, controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

SEEDS = [0, 1, 2**31 + 5, -3]


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("POCA_LOG_DIR", str(tmp_path / "logs"))


def _demo(w=16, h=12):
    scene = demo_scene(0).build(device="cpu")
    cam = Camera.make(w, h, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device="cpu")
    return scene, cam, torch.from_numpy(procedural_sky(16, 16))


def _as_tensor(seed):
    """The seed as a graph's buffer holds it: an i32 0-dim tensor."""
    return seed_word(seed, "cpu").reshape(())


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b, strict=True))


def _flat(out):
    """The tensors of a nested tuple of outputs, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out if x is not None for t in _flat(x)]


# ---- the seed as a tensor gives the int's bits


@pytest.mark.parametrize("seed", SEEDS)
def test_kernels_plain_versions_take_the_seed_word(seed):
    """mega_trace_plain (both forms) and the backward's plain version
    (replay_vjp, both forms) with the seed as an i32 tensor, 0-dim and of
    one element, give the int's bits, at seeds past 2^31 and below 0."""
    scene, cam, _ = _demo()
    gs = group_scene(scene)
    r = cam.width * cam.height
    pix = torch.arange(r, dtype=torch.int32)
    samp = torch.full((r,), 3, dtype=torch.int32)
    o, d = cam.ray_gen_planar(pix, samp, seed)
    geom = build_geom_rows(gs)
    ts, trt = build_tables_T(gs)
    forms = (seed, _as_tensor(seed), seed_word(seed, "cpu"))
    for aux in (False, True):
        outs = [mega_trace_plain(o, d, pix, samp, s, geom, ts, trt, counts=gs.counts, depth=3,
                                 with_aux=aux) for s in forms]
        assert all(_same(_flat(outs[0]), _flat(x)) for x in outs[1:]), aux
    hits = torch.stack(outs[0][6])
    gen = torch.Generator().manual_seed(1)
    ct = [torch.randn(r, generator=gen) for _ in range(13)]
    ct_aux = torch.randn(12, r, generator=gen) * (hits >= 0).repeat_interleave(4, 0)
    for cta in (None, ct_aux):
        grads = [mega_bwd_plain(o, d, pix, samp, s, ts, trt, hits, ct, ct_aux=cta,
                                with_carry=True) for s in forms]
        assert all(_same(_flat(grads[0]), _flat(g)) for g in grads[1:])


@pytest.mark.parametrize("seed", SEEDS)
def test_ray_gen_and_render_take_the_seed_word(seed):
    """Camera.ray_gen_planar and render_radiance (the megakernel route and
    the wavefront route) with a tensor seed: the int's bits."""
    scene, cam, sky = _demo()
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32)
    assert _same(_flat(cam.ray_gen_planar(pix, 2, seed)),
                 _flat(cam.ray_gen_planar(pix, 2, _as_tensor(seed))))
    kw = dict(spp=2, max_depth=3)
    assert _same(render_radiance(scene, cam, sky, seed=seed, **kw),
                 render_radiance(scene, cam, sky, seed=_as_tensor(seed), **kw))
    bvh = scene.with_bvh()
    assert _same(render_radiance(bvh, cam, sky, seed=seed, **kw),
                 render_radiance(bvh, cam, sky, seed=_as_tensor(seed), **kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_seed_render_matches_jax(monkeypatch, seed):
    """render_radiance with the seed as a tensor against JAX's
    render_radiance at the same seed, with
    tests/test_torch_render.py::test_render_controlled_scene_matches_jax's
    tolerances.  JAX's megakernel takes the seed as an int32, so a seed
    past 2^31 goes to it as its int32 bit pattern.  The camera is a
    pinhole (as in tests/test_torch_inverse.py), so the primary rays, and
    with them the first-hit buffers held on every pixel, do not move with
    the seed; with a lens, the jitter of seed 1 puts one primary ray on a
    silhouette where XLA's fused arithmetic and the port's round apart."""
    monkeypatch.setenv("POCA_MEGA", "1")
    jcam = JCamera.make(16, 12, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0),
                        lens_radius=0.0)
    jscene, sky = controlled_scene(), procedural_sky(16, 16)
    kw = dict(spp=2, max_depth=4)
    j_seed = int(_as_tensor(seed))
    ref = [np.asarray(a) for a in j_render_radiance(jscene, jcam, jnp.asarray(sky), seed=j_seed,
                                                     **kw)]
    got = [a.numpy() for a in render_radiance(port_scene(jscene), port_camera(jcam),
                                              port_sky(sky), seed=_as_tensor(seed), **kw)]
    close = np.isclose(got[0], ref[0], rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=5e-5)


def test_seed_word_refuses_other_forms():
    """A seed tensor is i32 with one element on the rays' device."""
    for bad in (torch.zeros((), dtype=torch.int64), torch.zeros(2, dtype=torch.int32),
                torch.zeros((), dtype=torch.float32)):
        with pytest.raises(ValueError, match="seed tensor"):
            seed_word(bad, "cpu")
    assert seed_word(torch.tensor([7], dtype=torch.int32), "cpu").tolist() == [7]
    assert seed_word(2**31 + 5, "cpu").tolist() == [-(2**31) + 5]


# ---- one capture over seeds


@pytest.mark.parametrize("route", ["megakernel", "wavefront", "chunked"])
def test_one_capture_serves_every_seed(monkeypatch, route):
    """render_graphed at seeds 0, 1 and 2 (and a tensor seed) through one
    capture, each bitwise its eager render; render_key does not change
    with the seed."""
    for k in ("POCA_MEGA", "POCA_PLANAR", "POCA_BVH", "POCA_SPP_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    scene, cam, sky = _demo()
    kw = dict(spp=4, max_depth=3, spp_chunk=2 if route == "chunked" else 1)
    if route == "wavefront":
        monkeypatch.setenv("POCA_MEGA", "0")
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    for seed in (0, 1, 2, _as_tensor(2**31 + 5)):
        got = render_graphed(runner, scene, cam, sky, seed=seed, **kw)
        assert _same(got, render_radiance(scene, cam, sky, seed=seed, **kw))
        assert len(runner.keys()) == 1
    assert runner.captures == backend.captured == 2  # the first chunk and a later one
    assert runner.keys() == [render_key(scene, cam, sky, **kw)]


def test_progressive_graph_serves_every_seed():
    """ProgressiveRenderer's frame graph over configs that differ only in
    seed: one capture, each frame bitwise frame_step's at its seed."""
    scene, cam, sky = _demo(12, 8)
    backend = RunBody()
    graphs = GraphedCall(max_entries=2, backend=backend)
    for seed in (0, 1, 2):
        cfg = RenderConfig(width=12, height=8, max_depth=3, seed=seed)
        r = ProgressiveRenderer(scene, cam, sky, cfg)
        r.graphs = graphs
        state = AccumulatorState.create(8, 12, "cpu")
        for _ in range(2):
            img = r.step_graphed()
            state, ref = frame_step(scene, cam, r.sky_tex, state, seed, cfg.max_depth,
                                    cfg.denoise, cfg.spp_per_frame)
            assert torch.equal(img, ref) and torch.equal(r.state.mix, state.mix)
    assert graphs.captures == backend.captured == 1 and len(graphs.keys()) == 1


# ---- the compiled video


def _path(n, w=12, h=8):
    cam = Camera.make(w, h, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device="cpu")
    return video.orbit_path(cam, n, degrees=40.0)


def _record_puts(monkeypatch):
    """The frames handed to the writer, kept as the tensors handed over."""
    put, got = video.AsyncFrameSink.put, []

    def recording(self, idx, image):
        got.append(image)
        put(self, idx, image)

    monkeypatch.setattr(video.AsyncFrameSink, "put", recording)
    return got


def _bytes(paths):
    return [open(p, "rb").read() for p in paths]


@pytest.mark.parametrize("use_denoise", [True, False])
def test_video_frame_graph_writes_the_eager_pngs(tmp_path, monkeypatch, use_denoise):
    """Five frames through one captured frame (render, denoise, pack): the
    PNG bytes of every frame equal the eager loop's, and every frame
    handed to the writer is its own tensor, still equal to the eager frame
    after every later replay (the graph's output buffer is overwritten in
    place by each replay)."""
    scene, _, sky = _demo()
    cams = _path(5)
    got = _record_puts(monkeypatch)
    eager = video.write_frames(None, scene, cams, sky, str(tmp_path / "eager"), spp=2,
                               max_depth=3, seed=4, denoise_frames=use_denoise)
    want = [g.clone() for g in got]
    got.clear()
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    graphed = video.write_frames(runner, scene, cams, sky, str(tmp_path / "graphed"), spp=2,
                                 max_depth=3, seed=4, denoise_frames=use_denoise)
    assert _bytes(graphed) == _bytes(eager)
    assert len(got) == 5 and all(torch.equal(g, w) for g, w in zip(got, want))
    entry = runner[runner.keys()[0]]
    assert all(g.data_ptr() != entry.rgb8.data_ptr() for g in got)
    assert len(runner.keys()) == 1 and runner.captures == backend.captured == 3  # first, later, pack
    assert backend.replays == 5 * 3


def test_video_over_a_mesh_graph_writes_the_eager_pngs(tmp_path, monkeypatch):
    """A 2x2 mesh video: the tiles through the mesh's tile graphs and the
    denoise and pack as one graph; PNG bytes equal the eager mesh video's
    and the unsharded compiled video's, one capture of each kind."""
    scene, _, sky = _demo()
    cams = _path(4, 12, 9)
    got = _record_puts(monkeypatch)
    mesh = make_tile_mesh(["cpu"] * 4)
    eager = video.write_frames(None, scene, cams, sky, str(tmp_path / "eager"), spp=1,
                               max_depth=2, seed=1, mesh=mesh)
    want = [g.clone() for g in got]
    got.clear()
    backend = RunBody()
    runner = GraphedCall(backend=backend)
    mesh2 = make_tile_mesh(["cpu"] * 4)
    graphed = video.write_frames(runner, scene, cams, sky, str(tmp_path / "graphed"), spp=1,
                                 max_depth=2, seed=1, mesh=mesh2)
    one = video.write_frames(GraphedCall(backend=RunBody()), scene, cams, sky,
                             str(tmp_path / "one"), spp=1, max_depth=2, seed=1)
    assert _bytes(graphed) == _bytes(eager) == _bytes(one)
    assert all(torch.equal(g, w) for g, w in zip(got[:4], want))
    tiles = tile_graphs(mesh2)
    assert len(tiles.keys()) == 1 and tiles.captures == 1
    assert len(runner.keys()) == 1 and runner.captures == 1
    assert tile_graphs(mesh2) is tiles and tile_graphs(mesh) is not tiles


def test_compiled_video_matches_jax(tmp_path, monkeypatch):
    """The compiled video (through the stand-in) against JAX's
    render_video on the controlled scene, 16x12, 2 spp, depth 3, three
    orbit frames at seeds 3-5, without the denoiser: at least 95% of each
    frame's pixels byte-equal to JAX's (the render's own bound: 95% of
    its radiance pixels within 5e-5, tests/test_torch_render.py; measured
    97.4-100%).  The denoiser spreads a path that XLA's arithmetic turns
    another way over its 5x5 neighbourhood, so the denoised frames are
    held to the eager loop's bytes (above) and the denoiser to JAX's
    (tests/test_torch_render.py::test_denoise_matches_jax)."""
    monkeypatch.setenv("POCA_MEGA", "1")
    jcam = JCamera.make(16, 12, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))
    jscene, sky = controlled_scene(), procedural_sky(16, 16)
    kw = dict(spp=2, max_depth=3, seed=3, denoise_frames=False)
    j_paths = j_video.render_video(jscene, j_video.orbit_path(jcam, 3, degrees=30.0),
                                   jnp.asarray(sky), str(tmp_path / "jax"), **kw)
    cams = video.orbit_path(port_camera(jcam), 3, degrees=30.0)
    paths = video.write_frames(GraphedCall(backend=RunBody()), port_scene(jscene), cams,
                               port_sky(sky), str(tmp_path / "port"), **kw)
    for a, b in zip(paths, j_paths, strict=True):
        same = (np.asarray(Image.open(a)) == np.asarray(Image.open(b))).all(-1)
        assert same.mean() >= 0.95, same.mean()


# ---- the compiled tiles


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (3, 2)])
def test_tile_graphs_are_the_eager_tiles(shape):
    """render_tiles through the mesh's graphs against the eager tiles, on
    padded meshes (15x10 over 2x2 and 3x2 pads rows or columns): bitwise;
    one capture for the (device, tile shape) key every tile shares; a
    second frame at another seed and camera captures nothing more."""
    scene, _, sky = _demo()
    cam = Camera.make(15, 10, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0),
                      device="cpu")
    mesh = make_tile_mesh(["cpu"] * (shape[0] * shape[1]), shape=shape)
    backend = RunBody()
    runner = tile_graphs(mesh, backend)
    assert runner.max_entries == shape[0] * shape[1]
    for seed, c in ((2, cam), (9, cam.move_forward(1.0))):
        kw = dict(spp=2, max_depth=3, seed=seed)
        got = render_tiles(runner, scene, c, sky, mesh, **kw)
        assert _same(got, render_tiles(None, scene, c, sky, mesh, **kw))
        assert len(runner.keys()) == 1 and runner.captures == backend.captured == 2
    assert backend.devices == {torch.device("cpu")}


def test_tile_graph_outputs_are_copies():
    """Tiles that share one graph each keep their own outputs: the 2x2
    mesh's frame equals the unsharded render (the tiles take its split
    plan at this size), so no tile reads another's buffers."""
    scene, cam, sky = _demo(16, 12)
    mesh = make_tile_mesh(["cpu"] * 4)
    got = render_tiles(tile_graphs(mesh, RunBody()), scene, cam, sky, mesh, spp=1, max_depth=2,
                       seed=3)
    rad, n0, t0 = render_radiance(scene, cam, sky, spp=1, max_depth=2, seed=3)
    assert _same(got, (rad.reshape(12, 16, 3), n0.reshape(12, 16, 3), t0.reshape(12, 16)))
