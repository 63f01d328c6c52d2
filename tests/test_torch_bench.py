"""The port's bench entry point (cpppathtracer_tpu_torch/bench.py, the CLI's
``bench``, the root bench_torch.py) and the card twin of the dense-vs-BVH
crossover harness (scripts/torch_bench_bvh.py), on the CPU.

The JAX side is built from the JAX modules as the root bench.py builds it
(bench.py:31-54); bench.py itself is not imported, since at import it
points JAX's compilation cache into the repository.
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

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops.texture import procedural_sky as j_procedural_sky
from cpppathtracer_tpu_torch import bench, convert
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import demo_scene
from cpppathtracer_tpu_torch.ops.texture import procedural_sky

from torch_port_helpers import port_camera, port_scene, port_sky

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _run(args, tmp_path, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), POCA_LOG_DIR=str(tmp_path / "logs"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_bench_subcommand_prints_one_json_line_on_cpu(tmp_path):
    """`python -m cpppathtracer_tpu_torch bench --device cpu`: rc 0 and
    stdout exactly one JSON line, at the CPU smoke size, without
    vs_baseline (a TPU target)."""
    proc = _run(["-m", "cpppathtracer_tpu_torch", "bench", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    res = json.loads(lines[0])
    assert sorted(res) == ["device", "metric", "unit", "value"], res
    assert res["unit"] == "rays/s" and res["device"] == "cpu" and res["value"] > 0
    assert res["metric"] == "rays/s fwd+bwd 64x64x2spp d4 (cpu)"
    assert "[bench]" in proc.stderr


def test_bench_refuses_cpu_fallback(monkeypatch):
    """Without --device and without a card, bench raises resolve_device's
    error; it does not run on the CPU (bench.py falls back, the port never
    does)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_build_bench_step_is_the_direct_computation():
    """build_bench's step bitwise equal to render_radiance, sum(rad^2) and
    autograd.grad written out on separately built inputs."""
    step, scene, camera, sky = bench.build_bench(16, 12, 2, 3, "cpu")
    loss, grads = step()
    assert sorted(grads) == ["emission", "kd"]

    s0 = demo_scene(seed=0).build(device="cpu")
    cam = Camera.make(16, 12, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device="cpu")
    sky0 = torch.from_numpy(procedural_sky(256, 256))
    kd, em = s0.kd.clone().requires_grad_(), s0.emission.clone().requires_grad_()
    rad, _, _ = render_radiance(s0.with_material_params({"kd": kd, "emission": em}), cam, sky0,
                                spp=2, max_depth=3, seed=0)
    ref = (rad * rad).sum()
    g_kd, g_em = torch.autograd.grad(ref, (kd, em))
    assert torch.equal(loss, ref.detach())
    assert torch.equal(grads["kd"], g_kd) and torch.equal(grads["emission"], g_em)
    assert torch.equal(sky, sky0)
    assert all(torch.equal(getattr(camera, f), getattr(cam, f)) for f in convert.CAMERA_FIELDS)


def test_build_bench_matches_jax_bench():
    """build_bench(16, 12, 1, 3, "cpu") against the JAX package built as
    bench.py:31-54 builds it: the same scene, camera and sky; on the pixels
    whose radiance agrees within 1e-5 (at least 80%), kd and emission
    gradients with cosine > 0.999 and norms within 5e-3
    (tests/test_torch_grad.py::test_render_grads_match_jax_demo's form);
    the step's loss equal to sum(rad^2) of the port's render, and the
    masked losses within 1e-5 relative (measured 6.0e-08).  Unmasked, the
    losses differ by 2.23e-02 relative (port 261.94467, JAX 267.92568):
    19 of the 192 pixels hold a path that takes another turn in XLA's
    arithmetic (tests/test_torch_render.py), and such a pixel carries the
    whole path's radiance."""
    step, scene, camera, sky = bench.build_bench(16, 12, 1, 3, "cpu")
    jscene = j_demo_scene(seed=0).build()
    jcam = JCamera.make(16, 12, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
    jsky = jnp.asarray(j_procedural_sky(256, 256))
    want, wcam = port_scene(jscene), port_camera(jcam)
    for f in convert.SCENE_FIELDS:
        assert torch.equal(getattr(scene, f), getattr(want, f)), f
    assert (scene.type_perm, scene.type_counts) == (want.type_perm, want.type_counts)
    for f in convert.CAMERA_FIELDS:
        assert torch.equal(getattr(camera, f), getattr(wcam, f)), f
    assert torch.equal(sky, port_sky(jsky))

    loss, _ = step()
    with torch.no_grad():
        rad = render_radiance(scene, camera, sky, spp=1, max_depth=3, seed=0)[0].numpy()
    rad_j = np.asarray(j_render_radiance(jscene, jcam, jsky, spp=1, max_depth=3, seed=0)[0])
    mask = (np.abs(rad - rad_j).max(-1) <= 1e-5).astype(np.float32)
    assert mask.mean() >= 0.8, mask.mean()
    assert float(loss) == pytest.approx(float(np.sum(rad.astype(np.float64) ** 2)), rel=1e-6)
    masked = [float(np.sum((r.astype(np.float64) * mask[:, None]) ** 2)) for r in (rad, rad_j)]
    assert masked[0] == pytest.approx(masked[1], rel=1e-5)

    kd, em = scene.kd.clone().requires_grad_(), scene.emission.clone().requires_grad_()
    rad_t, _, _ = render_radiance(scene.with_material_params({"kd": kd, "emission": em}), camera,
                                  sky, spp=1, max_depth=3, seed=0)
    rad_t = rad_t * torch.from_numpy(mask)[:, None]
    got = dict(zip(("kd", "emission"),
                   (g.numpy() for g in torch.autograd.grad((rad_t * rad_t).sum(), (kd, em)))))

    def loss_fn(params, m):
        s = jscene.with_material_params({**jscene.material_params(), **params})
        r, _, _ = j_render_radiance(s, jcam, jsky, spp=1, max_depth=3, seed=0)
        r = r * m[:, None]
        return jnp.sum(r * r)

    ref = jax.jit(jax.grad(loss_fn))({"kd": jscene.kd, "emission": jscene.emission},
                                     jnp.asarray(mask))
    for k in ("kd", "emission"):
        a, b = np.asarray(ref[k]).ravel(), got[k].ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
        assert cos > 0.999, (k, cos)
        assert abs(np.linalg.norm(b) / np.linalg.norm(a) - 1) < 5e-3, k


def _crossover_script():
    spec = importlib.util.spec_from_file_location("torch_bench_bvh",
                                                  REPO / "scripts" / "torch_bench_bvh.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_crossover_harness_on_cpu(tmp_path):
    """scripts/torch_bench_bvh.py at 64 and 2048 objects (16^2 x 1 spp x
    d1) on the CPU: the JAX script's JSON plus the device and the mega
    columns; all three columns at 64, dense and bvh at 2048, no device
    busy time from a CPU run; BVH_CROSSOVER.json byte for byte unchanged,
    and the script refuses to write it."""
    jax_file = REPO / "BVH_CROSSOVER.json"
    before = jax_file.read_bytes()
    out = tmp_path / "crossover.json"
    proc = _run(["scripts/torch_bench_bvh.py", "--device", "cpu", "--sizes", "64,2048",
                 "--res", "16", "--spp", "1", "--depth", "1", "--out", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.splitlines()) == 1, proc.stdout
    res = json.loads(out.read_text())
    assert sorted(res) == ["backend", "config", "crossover_n", "device", "mega_crossover_n", "rows"]
    assert res["backend"] == "cpu" and res["device"] == "cpu"
    assert res["config"] == {"res": 16, "spp": 1, "depth": 1}
    assert [r["n_objects"] for r in res["rows"]] == [64, 2048]
    small, large = res["rows"]
    for mode in ("dense", "bvh", "mega"):
        assert small[f"{mode}_s"] > 0 and small[f"{mode}_mrays_s"] > 0, mode
        assert small[f"{mode}_busy_ms"] is None and large[f"{mode}_busy_ms"] is None
    assert large["dense_s"] > 0 and large["bvh_s"] > 0
    assert small["speedup"] == small["dense_s"] / small["bvh_s"]
    assert jax_file.read_bytes() == before

    with pytest.raises(SystemExit, match="BVH_CROSSOVER.json"):
        _crossover_script().main(["--device", "cpu", "--out", str(jax_file)])
    assert jax_file.read_bytes() == before
