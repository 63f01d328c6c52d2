"""The port's entry points on the CPU: video rendering, the interactive viewer,
checkpoints, PNG output and the command line, as twins of the JAX
package's tests of them (tests/test_video.py, tests/test_interactive.py,
tests/test_renderer.py::test_accumulator_checkpoint_roundtrip) and
against the JAX package on the same inputs."""

import functools
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from cpppathtracer_tpu import __main__ as j_main
from cpppathtracer_tpu import interactive as j_interactive
from cpppathtracer_tpu import video as j_video
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.renderer import AccumulatorState as JAccumulatorState
from cpppathtracer_tpu.utils import checkpoint as j_checkpoint
from cpppathtracer_tpu.utils import png as j_png
from cpppathtracer_tpu_torch import __main__ as t_main
from cpppathtracer_tpu_torch import interactive
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.interactive import apply_key, frame_to_ansi, run
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.presets import PRESETS
from cpppathtracer_tpu_torch.models.scene import SceneBuilder
from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise
from cpppathtracer_tpu_torch.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.renderer import (
    AccumulatorState,
    ProgressiveRenderer,
    RenderConfig,
    to_rgb8,
)
from cpppathtracer_tpu_torch.utils import checkpoint
from cpppathtracer_tpu_torch.utils.png import write_png
from cpppathtracer_tpu_torch.video import AsyncFrameSink, fly_path, orbit_path, render_video

from torch_port_helpers import port_camera

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("POCA_LOG_DIR", str(tmp_path / "logs"))


def _sky(h=16, w=16, seed=0):
    return torch.from_numpy(procedural_sky(h, w, seed=seed))


def _scene(kd=(0.6, 0.2, 0.2)):
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=kd)
    return b.build(device=CPU)


def _read(path):
    return np.asarray(Image.open(path))


# ---- twins of tests/test_video.py


def test_orbit_path_lengths():
    cam = Camera.make(8, 8, origin=(10.0, 5.0, 0.0), look_at=(0.0, 0.0, 0.0), device=CPU)
    path = orbit_path(cam, 12)
    assert len(path) == 12
    for c in path:
        d = np.linalg.norm((c.origin - c.look_at).numpy())
        np.testing.assert_allclose(d, np.sqrt(125.0), rtol=1e-5)


def test_fly_path_moves():
    cam = Camera.make(8, 8, origin=(0.0, 5.0, -10.0), look_at=(0.0, 0.0, 0.0), device=CPU)
    path = fly_path(cam, 5, keys="w")
    assert len(path) == 5
    assert not np.allclose(path[-1].origin.numpy(), cam.origin.numpy())


def test_render_video_writes_frames(tmp_path):
    cam = Camera.make(12, 8, origin=(0.0, 4.0, -10.0), look_at=(0.0, 2.0, 0.0), device=CPU)
    frames = render_video(
        _scene(), orbit_path(cam, 3, degrees=30.0), _sky(), str(tmp_path), spp=1, max_depth=2,
    )
    assert len(frames) == 3
    for f in frames:
        assert os.path.exists(f), f
    assert _read(frames[0]).shape == (8, 12, 3)


def test_render_video_frame_equals_direct_render(tmp_path):
    """Frame i is the render of camera i at seed + i, denoised and packed
    as to_rgb8 packs it."""
    scene, sky = _scene(), _sky()
    cams = orbit_path(Camera.make(12, 8, origin=(0.0, 4.0, -10.0), look_at=(0.0, 2.0, 0.0),
                                  device=CPU), 2, degrees=30.0)
    frames = render_video(scene, cams, sky, str(tmp_path), spp=1, max_depth=2, seed=5)
    rad, n0, t0 = render_radiance(scene, cams[1], sky, spp=1, max_depth=2, seed=6)
    want = to_rgb8(denoise(rad.reshape(8, 12, 3), n0.reshape(8, 12, 3), t0.reshape(8, 12)))
    np.testing.assert_array_equal(_read(frames[1]), want)


def test_render_video_over_a_mesh_writes_the_same_frames(tmp_path):
    """render_video(mesh=) tiles each frame over the mesh
    (render_image_sharded); its PNGs equal the unsharded video's."""
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh

    scene, sky = _scene(), _sky()
    cams = orbit_path(Camera.make(12, 9, origin=(0.0, 4.0, -10.0), look_at=(0.0, 2.0, 0.0),
                                  device=CPU), 2, degrees=40.0)
    one = render_video(scene, cams, sky, str(tmp_path / "one"), spp=1, max_depth=2, seed=1)
    tiled = render_video(scene, cams, sky, str(tmp_path / "tiled"), spp=1, max_depth=2, seed=1,
                         mesh=make_tile_mesh([CPU] * 4))
    for a, b in zip(one, tiled):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_frame_sink_raises_on_writer_error(tmp_path):
    """A failed write surfaces on the render thread (from put or close),
    and a full queue does not hang the renderer."""
    sink = AsyncFrameSink(str(tmp_path))
    sink.put(0, np.zeros((4, 4, 2), np.uint8))  # two channels: no PNG colour type
    with pytest.raises(RuntimeError, match="frame writer failed"):
        for i in range(1, 64):  # the queue holds 8: the writer meets frame 0 before the end
            sink.put(i, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="frame writer failed"):
        sink.close()
    assert not sink._thread.is_alive()


@pytest.mark.parametrize("keys", ["w", "ad", "wq", "sde"])
def test_camera_paths_equal_jax_bitwise(keys):
    """orbit_path and fly_path give the JAX package's camera origins
    bitwise, the JAX camera carried across with convert.camera_from_numpy."""
    jcam = JCamera.make(8, 6, origin=(10.0, 5.0, -3.0), look_at=(0.5, 1.0, 0.0))
    cam = port_camera(jcam)
    for got, want in zip(orbit_path(cam, 7, degrees=200.0), j_video.orbit_path(jcam, 7, 200.0)):
        np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    for got, want in zip(fly_path(cam, 4, keys), j_video.fly_path(jcam, 4, keys)):
        np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
        np.testing.assert_array_equal(got.look_at.numpy(), np.asarray(want.look_at))


# ---- twins of tests/test_interactive.py


def _setup(w=16, h=10):
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.6, 0.3, 0.3))
    cam = Camera.make(w, h, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device=CPU)
    return b.build(device=CPU), cam


def test_frame_to_ansi_shape():
    img = np.random.RandomState(0).uniform(0, 1, (10, 16, 3)).astype(np.float32)
    s = frame_to_ansi(img)
    assert s.count("\n") == 4  # 10 rows -> 5 lines, 4 newlines
    assert "▀" in s and "\x1b[38;2;" in s


def test_scripted_session_moves_camera_and_renders():
    scene, cam = _setup()
    out = io.StringIO()
    frames = run(scene, cam, _sky(), max_depth=2, max_frames=6,
                 key_source=iter(["w", "i", "r", "d"]), out=out)
    assert frames == 5  # 1 initial + one per key, then StopIteration
    text = out.getvalue()
    assert "spp" in text and "▀" in text


def test_apply_key_motion_refreshes():
    scene, cam = _setup()
    r = ProgressiveRenderer(scene, cam, _sky(),
                            RenderConfig(width=cam.width, height=cam.height, max_depth=2))
    r.step()
    assert r.state.sample_idx == 1
    assert apply_key("w", r)
    assert r.state.sample_idx == 0  # refreshed
    assert not np.allclose(r.camera.origin.numpy(), cam.origin.numpy())
    assert apply_key("\x1b", r) is False


def test_apply_key_fov():
    scene, cam = _setup()
    r = ProgressiveRenderer(scene, cam, _sky(),
                            RenderConfig(width=cam.width, height=cam.height, max_depth=2))
    f0 = float(r.camera.view_fov)
    apply_key("+", r)
    assert float(r.camera.view_fov) > f0


@pytest.mark.parametrize("h", [9, 10])
def test_frame_to_ansi_equals_jax(h):
    img = np.random.RandomState(h).uniform(-0.1, 1.1, (h, 7, 3)).astype(np.float32)
    assert frame_to_ansi(img) == j_interactive.frame_to_ansi(img)


# ---- checkpoints


def _renderer(w=12, h=8):
    cfg = RenderConfig(width=w, height=h, max_depth=3)
    cam = Camera.make(w, h, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device=CPU)
    return ProgressiveRenderer(_scene((0.6, 0.3, 0.3)), cam, torch.from_numpy(
        procedural_sky(32, 32, seed=1)), cfg)


def test_accumulator_checkpoint_roundtrip(tmp_path):
    r = _renderer()
    r.step()
    r.step()
    path = str(tmp_path / "acc.npz")
    checkpoint.save(path, r.state, {"note": "test"})
    like = AccumulatorState.create(r.camera.height, r.camera.width, CPU)
    restored, meta = checkpoint.restore(path, like)
    assert meta["note"] == "test"
    torch.testing.assert_close(restored.mix, r.state.mix, rtol=0, atol=0)
    assert restored.sample_idx == 2 and isinstance(restored.sample_idx, int)
    # resuming continues identically
    r2 = _renderer()
    r2.state = restored
    assert torch.equal(r.step(), r2.step())


def test_checkpoint_files_cross_restore(tmp_path):
    """A dict of arrays and an AccumulatorState saved by either package
    restore in the other; the port gives back an int sample_idx."""
    rng = np.random.RandomState(3)
    tree = {"b": rng.randn(3, 2).astype(np.float32), "a": [rng.randint(0, 9, 4).astype(np.int32),
                                                          rng.randn(2).astype(np.float32)]}
    like = {"a": [torch.zeros(4, dtype=torch.int32), torch.zeros(2)], "b": torch.zeros(3, 2)}
    mix = rng.uniform(0, 1, (4, 5, 3)).astype(np.float32)

    j_checkpoint.save(str(tmp_path / "j_tree.npz"), tree, {"k": 1})
    got, meta = checkpoint.restore(str(tmp_path / "j_tree.npz"), like)
    assert meta == {"k": 1}
    np.testing.assert_array_equal(got["b"].numpy(), tree["b"])
    np.testing.assert_array_equal(got["a"][0].numpy(), tree["a"][0])
    np.testing.assert_array_equal(got["a"][1].numpy(), tree["a"][1])

    checkpoint.save(str(tmp_path / "t_tree.npz"),
                    {"b": torch.from_numpy(tree["b"]), "a": [torch.from_numpy(a) for a in tree["a"]]})
    got, _ = j_checkpoint.restore(str(tmp_path / "t_tree.npz"), tree)
    for x, y in zip([got["a"][0], got["a"][1], got["b"]], [*tree["a"], tree["b"]]):
        np.testing.assert_array_equal(np.asarray(x), y)

    import jax.numpy as jnp

    j_checkpoint.save(str(tmp_path / "j_acc.npz"),
                      JAccumulatorState(mix=jnp.asarray(mix), sample_idx=jnp.int32(7)))
    got, _ = checkpoint.restore(str(tmp_path / "j_acc.npz"), AccumulatorState.create(4, 5, CPU))
    np.testing.assert_array_equal(got.mix.numpy(), mix)
    assert got.sample_idx == 7 and isinstance(got.sample_idx, int)

    checkpoint.save(str(tmp_path / "t_acc.npz"),
                    AccumulatorState(mix=torch.from_numpy(mix), sample_idx=9))
    got, _ = j_checkpoint.restore(str(tmp_path / "t_acc.npz"), JAccumulatorState.create(4, 5))
    np.testing.assert_array_equal(np.asarray(got.mix), mix)
    assert int(got.sample_idx) == 9


# ---- PNG bytes


@pytest.mark.parametrize("kind", ["uint8_rgb", "uint8_rgba", "float", "gray"])
def test_write_png_bytes_equal_jax(tmp_path, kind):
    rng = np.random.RandomState(11)
    img = {
        "uint8_rgb": rng.randint(0, 256, (7, 9, 3)).astype(np.uint8),
        "uint8_rgba": rng.randint(0, 256, (5, 4, 4)).astype(np.uint8),
        "float": rng.uniform(-0.2, 1.2, (6, 8, 3)).astype(np.float32),
        "gray": rng.randint(0, 256, (3, 5)).astype(np.uint8),
    }[kind]
    j_png.write_png(str(tmp_path / "j.png"), img)
    write_png(str(tmp_path / "t.png"), torch.from_numpy(img))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


# ---- the command line, in process


def _cli(*argv):
    t_main.main([*argv, "--device", CPU])


def test_cli_render_equals_direct_render(tmp_path):
    out = str(tmp_path / "r.png")
    _cli("render", "--preset", "cornell", "--size", "20x14", "--spp", "2", "--depth", "2",
         "--seed", "3", "--out", out)
    scene, cam = PRESETS["cornell"].build(device=CPU)
    cam = cam.resize(20, 14)
    sky = t_main._load_sky(None, CPU)
    rad, n0, t0 = render_radiance(scene, cam, sky, spp=2, max_depth=2, seed=3)
    want = to_rgb8(denoise(rad.reshape(14, 20, 3), n0.reshape(14, 20, 3), t0.reshape(14, 20)))
    np.testing.assert_array_equal(_read(out), want)


def test_cli_render_matches_jax(tmp_path):
    """cornell at 32x24, 1 spp, depth 1, no denoiser, through both command
    lines: primaries agree except on exact float32 ties (ROADMAP queue 3),
    so at least 99% of the pixels lie within 1 LSB in every channel."""
    argv = ["render", "--preset", "cornell", "--size", "32x24", "--spp", "1", "--depth", "1",
            "--no-denoise", "--out"]
    j_main.main([*argv, str(tmp_path / "j.png")])
    _cli(*argv, str(tmp_path / "t.png"))
    a = _read(tmp_path / "t.png").astype(np.int32)
    b = _read(tmp_path / "j.png").astype(np.int32)
    assert a.shape == b.shape == (24, 32, 3)
    close = (np.abs(a - b) <= 1).all(-1).mean()
    assert close >= 0.99, close


def test_cli_progressive_and_interactive(tmp_path, monkeypatch):
    out = str(tmp_path / "p.png")
    _cli("progressive", "--preset", "cornell", "--size", "16x12", "--depth", "2", "--frames", "3",
         "--out", out)
    assert _read(out).shape == (12, 16, 3)
    screen = io.StringIO()
    monkeypatch.setattr(interactive, "run", functools.partial(interactive.run, out=screen))
    _cli("interactive", "--preset", "cornell", "--size", "8x6", "--depth", "2", "--frames", "2")
    assert screen.getvalue().count("spp ") == 2


def test_cli_video_writes_frames(tmp_path):
    out = tmp_path / "frames"
    _cli("video", "--preset", "cornell", "--size", "12x8", "--spp", "1", "--depth", "2",
         "--frames", "3", "--out-dir", str(out))
    names = sorted(os.listdir(out))
    assert names == [f"frame_{i:05d}.png" for i in range(3)]
    assert _read(out / names[2]).shape == (8, 12, 3)


def test_cli_invert_lowers_loss(tmp_path):
    """The verify recipe's cornell fit (24^2, 1 spp, depth 2, 30 steps):
    the loss falls at least tenfold (the JAX package: 1.181e-02 ->
    2.604e-04)."""
    out = tmp_path / "inv"
    _cli("invert", "--preset", "cornell", "--res", "24", "--spp", "1", "--depth", "2",
         "--steps", "30", "--out-dir", str(out))
    losses = [json.loads(line)["loss"] for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 30 and losses[-1] * 10 < losses[0], losses
    assert _read(out / "fitted.png").shape == (24, 24, 3)
    assert _read(out / "target.png").shape == (24, 24, 3)


def test_cli_defaults_to_the_card():
    """Without --device the command line runs on the CUDA card, and raises
    where there is none; it never moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main.main(["render", "--preset", "cornell", "--size", "4x4"])


def test_obs_timer_meter_metrics_and_trace(tmp_path):
    from cpppathtracer_tpu_torch.utils.obs import MetricsLog, RaysPerSecond, Timer

    sink = {}
    with Timer.phase("work", sink) as ph:
        ph["result"] = {"a": [torch.ones(3) * 2]}
    assert sink["work"] > 0
    meter = RaysPerSecond()
    meter.add(4, 2, 3, 5, 0.5)
    assert meter.report() == {"rays": 120, "seconds": 0.5, "rays_per_sec": 240.0}
    metrics = MetricsLog(str(tmp_path / "m" / "metrics.jsonl"))
    metrics.log(step=0, loss=1.5)
    assert json.loads((tmp_path / "m" / "metrics.jsonl").read_text())["loss"] == 1.5
