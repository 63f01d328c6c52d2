"""The card twins of the JAX package's video, scaling and progressive
harnesses (scripts/torch_bench_video.py, torch_bench_scaling.py,
torch_perf_progressive.py), on the CPU: each run as a user runs it, with
--device cpu, and its outputs held against the JAX package.

The JAX side is built from the JAX modules; scripts/bench_video.py and
scripts/perf_progressive.py are not imported, since at import they point
JAX's compilation cache into the repository, and scripts/bench_scaling.py
rewrites XLA_FLAGS.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cpppathtracer_tpu import video as j_video
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops.texture import procedural_sky as j_procedural_sky
from cpppathtracer_tpu.parallel.mesh import make_tile_mesh as j_make_tile_mesh
from cpppathtracer_tpu.parallel.render import global_pixel_grid as j_global_pixel_grid
from cpppathtracer_tpu.parallel.render import make_sharded_loss as j_make_sharded_loss
from cpppathtracer_tpu_torch import video
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import demo_scene
from cpppathtracer_tpu_torch.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
from cpppathtracer_tpu_torch.parallel.render import global_pixel_grid, make_sharded_loss
from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig

from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CAMERA = dict(origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
SCRIPTS = ("torch_bench_video.py", "torch_bench_scaling.py", "torch_perf_progressive.py")


def _run(args, tmp_path, env=None, timeout=240):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(PYTHONPATH=str(REPO), POCA_LOG_DIR=str(tmp_path / "logs"), OMP_NUM_THREADS="1",
                **(env or {}))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=full, capture_output=True,
                          text=True, timeout=timeout)


def _script(name):
    spec = importlib.util.spec_from_file_location(name[:-3], REPO / "scripts" / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _one_line(proc):
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


# ---- (1) the video harness, (2) its frames against JAX's render_video


def test_video_harness_on_cpu(tmp_path):
    """2 frames of 16^2 x 1 spp x d2: one stdout line, the JAX harness's
    keys and the port's, 2 checksums, the warm-up's frame 0 equal to the
    timed one; VIDEO_r4.json and VIDEO_r5.json byte for byte unchanged,
    and the script refuses to write them."""
    jax_files = {f: (REPO / f).read_bytes() for f in ("VIDEO_r4.json", "VIDEO_r5.json")}
    out = tmp_path / "video.json"
    summary = _one_line(_run(["scripts/torch_bench_video.py", "--device", "cpu", "--frames", "2",
                              "--size", "16", "--spp", "1", "--depth", "2", "--out", str(out)],
                             tmp_path))
    assert sorted(summary) == ["device", "fps", "frames", "mrays_s"], summary
    assert summary["device"] == "cpu" and summary["frames"] == 2 and summary["fps"] > 0
    res = json.loads(out.read_text())
    assert sorted(res) == sorted([
        "backend", "config", "wall_s", "fps", "rays_per_s", "frame_sha256_16", "device",
        "first_frame_s", "render_only_wall_s", "png_ms_per_frame", "busy_ms_per_frame",
        "warmup_frame0_sha256_16"])
    assert res["png_ms_per_frame"] > 0
    assert res["backend"] == "cpu" and res["busy_ms_per_frame"] is None
    assert res["config"] == {"frames": 2, "size": 16, "spp": 1, "depth": 2,
                             "scene": "demo (~93 objects)", "path": "orbit 360deg"}
    assert res["rays_per_s"] == pytest.approx(16 * 16 * 1 * 2 * 2 / res["wall_s"])
    assert len(res["frame_sha256_16"]) == 2
    assert res["frame_sha256_16"][0] == res["warmup_frame0_sha256_16"]
    assert res["frame_sha256_16"][0] != res["frame_sha256_16"][1]  # the camera moved
    for name in jax_files:
        with pytest.raises(SystemExit, match=name):
            _script("torch_bench_video.py").main(["--device", "cpu", "--out", str(REPO / name)])
    assert {f: (REPO / f).read_bytes() for f in jax_files} == jax_files


def test_video_frames_match_jax(tmp_path):
    """The port's orbit frames (uint8, from video.render_video) against the
    JAX package's render_video on the same scene, cameras and seed, at
    16x12 x 1 spp x d2, 3 frames of a 360-degree orbit: at least 90% of the
    uint8 values within 1 (measured: 1,557 of 1,728, 90.10%).  The rest
    come from secondary lanes whose paths take another turn in XLA's CPU
    arithmetic (ROADMAP.md queue 3, "Forward paths against XLA's CPU
    arithmetic"), which the denoiser's 5x5 filter spreads to their
    neighbours: without it, 17 of the 576 pixels differ by more than 1
    (97.05% of the values within 1)."""
    jcam = JCamera.make(16, 12, **CAMERA)
    jpaths = j_video.render_video(j_demo_scene(seed=0).build(), j_video.orbit_path(jcam, 3),
                                  jnp.asarray(j_procedural_sky(256, 256)), str(tmp_path / "jax"),
                                  spp=1, max_depth=2, seed=0)
    cam = Camera.make(16, 12, device="cpu", **CAMERA)
    paths = video.render_video(demo_scene(seed=0).build(device="cpu"), video.orbit_path(cam, 3),
                               torch.from_numpy(procedural_sky(256, 256)), str(tmp_path / "port"),
                               spp=1, max_depth=2, seed=0)
    got = np.stack([np.asarray(Image.open(p)) for p in paths]).astype(np.int16)
    want = np.stack([np.asarray(Image.open(p)) for p in jpaths]).astype(np.int16)
    assert got.shape == want.shape == (3, 12, 16, 3)
    share = float((np.abs(got - want) <= 1).mean())
    assert share >= 0.90, share


# ---- (3) the scaling harness, (4) the sharded loss against JAX's


def test_scaling_harness_on_cpu(tmp_path):
    """n = 1, 2 in both modes (8^2 tiles, 1 spp, d2; the procs mode two
    gloo processes): one stdout line, the rows' keys, efficiency 1.0 at
    n = 1 in each mode, every row's check against the one-device step
    passed, eager and compiled (on the CPU make_sharded_value_and_grad's
    call is the eager step, its loss the eager loss bit for bit);
    SCALING_r4.json and SCALING_r5.json unchanged."""
    jax_files = {f: (REPO / f).read_bytes() for f in ("SCALING_r4.json", "SCALING_r5.json")}
    out = tmp_path / "scaling.json"
    summary = _one_line(_run(["scripts/torch_bench_scaling.py", "--device", "cpu", "--counts",
                              "1,2", "--tile", "8", "--spp", "1", "--depth", "2", "--mode", "both",
                              "--out", str(out)], tmp_path))
    assert summary["device"] == "cpu"
    assert [(r["n"], r["mode"]) for r in summary["scaling"]] == [
        (1, "process"), (2, "process"), (1, "procs"), (2, "procs")]
    res = json.loads(out.read_text())
    assert res["backend"] == "cpu" and res["config"] == {"tile": 8, "spp": 1, "depth": 2}
    want = {"n_devices", "mode", "mesh", "image", "step_s", "rays_per_s", "loss", "comm_bytes",
            "comm_step_s", "dispatch_s", "compute_s_est", "efficiency", "busy_ms", "peak_gib",
            "check"}
    images = {("process", 1): [8, 8], ("process", 2): [8, 16], ("procs", 1): [8, 8],
              ("procs", 2): [16, 8]}
    for r in res["rows"]:
        assert want <= set(r), r
        assert r["image"] == images[(r["mode"], r["n_devices"])]
        assert r["check"]["ok"] and r["busy_ms"] is None and r["peak_gib"] is None
        assert r["comm_bytes"] == 93 * (3 + 1) * 4  # kd f32[93, 3] and emission f32[93]
        if r["n_devices"] == 1:
            assert r["efficiency"] == 1.0
        c = r["compiled"]
        assert set(c) == {"first_s", "step_s", "busy_ms", "check", "loss_bitwise", "rays_per_s",
                          "efficiency"}, c
        assert c["check"]["ok"] and c["loss_bitwise"] and c["busy_ms"] is None
        assert c["step_s"] > 0 and c["first_s"] > 0
        assert c["efficiency"] == 1.0 or r["n_devices"] != 1
    assert [s["eff_compiled"] for s in summary["scaling"]][0::2] == [1.0, 1.0]
    procs = [r for r in res["rows"] if r["mode"] == "procs"]
    assert all(r["backend"] == "gloo" for r in procs)
    # the same 8x8 image in both modes at n = 1
    assert procs[0]["loss"] == pytest.approx(res["rows"][0]["loss"], rel=1e-5)
    for name in jax_files:
        with pytest.raises(SystemExit, match=name):
            _script("torch_bench_scaling.py").main(["--device", "cpu", "--out", str(REPO / name)])
    assert {f: (REPO / f).read_bytes() for f in jax_files} == jax_files


def test_scaling_harness_rank_past_its_limit_shows_its_stacks(tmp_path):
    """A procs rank still running at --rank-timeout prints its threads'
    stacks and exits non-zero, and the run fails with its exit code and
    writes no result."""
    out = tmp_path / "scaling.json"
    proc = _run(["scripts/torch_bench_scaling.py", "--device", "cpu", "--counts", "1",
                 "--tile", "8", "--spp", "1", "--depth", "2", "--mode", "procs",
                 "--rank-timeout", "0.01", "--out", str(out)], tmp_path)
    assert proc.returncode != 0 and proc.stdout == "" and not out.exists()
    assert "Timeout" in proc.stderr and "rank_main" in proc.stderr
    assert "rank exit codes [1]" in proc.stderr


def test_mesh_cards_processes_on_cpu(tmp_path):
    """scripts/torch_mesh_cards.py's second part as its docstring runs it
    on the CPU (two gloo processes, 32^2): the gathered frame bitwise the
    unsharded render, and make_sharded_train_step's eager and compiled
    forms (on the CPU the compiled call is the eager step) held to the
    single device's loss and gradients, the losses bit for bit, each
    form's step timed."""
    proc = _run(["scripts/torch_mesh_cards.py", "--device", "cpu", "--procs", "2", "--size",
                 "32", "--spp", "1", "--reps", "1"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    head, line = proc.stdout.splitlines()
    assert head.startswith("[mesh] cpu")
    out = json.loads(line)
    assert out["part"] == "2 processes" and out["backend"] == "gloo" and out["bitwise"]
    assert out["train_close"] and out["train_loss_bitwise"]
    assert all(out[k] > 0 for k in ("train_step_ms", "train_step_compiled_ms",
                                    "train_first_compiled_ms"))


def test_sharded_loss_matches_jax_over_two_devices():
    """The port's make_sharded_loss over a 1x2 mesh of "cpu" entries, its
    value and kd / emission gradients by torch.autograd.grad, against JAX's
    make_sharded_loss over jax.devices()[:2] and jax.value_and_grad, on the
    controlled scene at 16x8 x 1 spp x d1, where the forward paths agree up
    to ties: loss within rtol 1e-5 (measured: 6.3e-08 relative, one float32
    ulp), gradients within rtol 1e-4 / atol 1e-7 (measured: kd equal,
    emission 3.7e-09 apart at most)."""
    jscene = controlled_scene()
    jcam = JCamera.make(16, 8, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0))
    jsky = jnp.asarray(j_procedural_sky(16, 16, seed=3))
    jmesh = j_make_tile_mesh(jax.devices()[:2])
    jpix = j_global_pixel_grid(jcam, jmesh)
    jtarget = jnp.full(jpix.shape + (3,), 0.25, jnp.float32)
    jparams = {k: jscene.material_params()[k] for k in ("kd", "emission")}
    jloss, jgrads = jax.jit(jax.value_and_grad(j_make_sharded_loss(jmesh, spp=1, max_depth=1)))(
        jparams, jscene, jcam, jsky, jpix, jtarget)

    scene, cam, sky = port_scene(jscene), port_camera(jcam), port_sky(jsky)
    mesh = make_tile_mesh(["cpu"] * 2)
    assert mesh.shape == tuple(jmesh.devices.shape) == (1, 2)
    pix = global_pixel_grid(cam, mesh)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(jpix))
    full = scene.material_params()
    params = {k: full[k].detach().clone().requires_grad_(True) for k in ("kd", "emission")}
    loss = make_sharded_loss(mesh, spp=1, max_depth=1)(params, scene, cam, sky, pix,
                                                       torch.from_numpy(np.array(jtarget)))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


# ---- (5) the progressive harness


def test_progressive_harness_on_cpu(tmp_path):
    """2 frames of 16x12 at d2: one stdout line with the denoiser on and
    off, in that order, and no device busy time and no frame graph from a
    CPU run."""
    proc = _run(["scripts/torch_perf_progressive.py", "--device", "cpu", "--frames", "2",
                 "--size", "16x12", "--depth", "2"], tmp_path)
    summary = _one_line(proc)
    assert summary["device"] == "cpu" and summary["graphed"] is False
    assert [r["denoise"] for r in summary["progressive"]] == [True, False]
    for r in summary["progressive"]:
        assert sorted(r) == ["busy_ms", "denoise", "fps", "ms_per_frame"]
        assert r["busy_ms"] is None and r["ms_per_frame"] > 0
        assert r["fps"] == pytest.approx(1e3 / r["ms_per_frame"])
    for denoise in (True, False):  # the JAX script's text line, on stderr
        assert f"[progressive 16x12x1spp d2 denoise={denoise}]" in proc.stderr


@pytest.mark.parametrize("denoise", [True, False])
def test_progressive_harness_image_is_the_direct_loop(denoise):
    """The harness's setting (a warm-up step and 2 timed steps) leaves the
    accumulated image bitwise equal to a ProgressiveRenderer driven
    directly for 3 steps."""
    harness = _script("torch_perf_progressive.py")
    scene = demo_scene(seed=0).build(device="cpu")
    cam = Camera.make(16, 12, device="cpu", **CAMERA)
    sky = torch.from_numpy(procedural_sky(256, 256))
    row, r = harness.run_setting(scene, cam, sky, 2, denoise, 2, torch.device("cpu"))
    assert row["denoise"] is denoise and row["busy_ms"] is None
    direct = ProgressiveRenderer(scene, cam, sky,
                                 RenderConfig(width=16, height=12, max_depth=2, denoise=denoise))
    for _ in range(3):
        direct.step()
    np.testing.assert_array_equal(r.frame(), direct.frame())


# ---- (6) no fallback to the CPU


@pytest.mark.parametrize("script", SCRIPTS)
def test_harness_without_a_card_raises(script, tmp_path):
    """Without --device and without a card the harness exits non-zero with
    resolve_device's error, prints nothing on stdout and writes no JSON."""
    out = tmp_path / "out.json"
    proc = _run([f"scripts/{script}", "--out", str(out)], tmp_path,
                env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr, proc.stderr[-2000:]
    assert proc.stdout == "" and not out.exists()
