"""Tests of the benchmark harness (benchmark/): registry, arithmetic, the
result line, each traffic kind's loop at a toy size on the CPU through the
program's plain versions (control flow only: no CPU number stands for a
device metric), the control and the planted faults that the comparison must
reject, the no-card exit and the no-JAX check.

    python -m pytest benchmark/tests -q

Card tests carry the `gpu` marker and skip without a card; run them on the
card with `python -m pytest --noconftest -o addopts="" -m gpu benchmark/tests -q`.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import judge, peaks, registry, runner, stats, trace  # noqa: E402

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(cell: str, seed: int = 2**31 + 77, trace_on: bool = False):
    """The cell's context cut to a toy size on the CPU: 16x12 pixels, 2
    samples, depth 3, big scenes at 2048 objects (still past the BVH
    threshold), short flythroughs, few check pixels."""
    torch.set_num_threads(2)
    cards = [torch.device("cpu")] * int(registry.workload(cell)["chips"])
    ctx = runner.make_context(cell, seed, 0.2, trace_on, cards)
    ctx.settings.update(width=16, height=12, spp=2)
    ctx.config["depth"] = 3
    if ctx.config["scene"]["generator"] == "big_scene":
        ctx.config["scene"]["args"]["n"] = 2048
        ctx.config["camera"]["n"] = 2048
        ctx.config["objects"] = {"spheres": 1365, "platforms": 1, "cylinders": 682}
    p = ctx.workload["params"]
    if "check_pixels" in p:
        p["check_pixels"] = 32
    if "legs" in p:
        p.update(legs=[["w", 3], ["", 4], ["sa", 2]], check_frames=3)
    ctx.workload["trace_iterations"] = 3
    ctx.workload.pop("label_iterations", None)
    return ctx


def run_tiny(cell, trace_on=False, iterations=6, **kw):
    ctx = tiny(cell, trace_on=trace_on, **kw)
    kind = registry.traffic(ctx.workload["traffic"])
    st = kind.setup(ctx)
    out = kind.run(st, ctx, iterations=iterations)
    kind.release(st, ctx)
    return ctx, kind, st, out


def over_limit(numbers: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in numbers.items())


# ---- registry: every configuration and cell by name


@pytest.mark.parametrize("cell", CELLS)
def test_cells_load_by_name(cell):
    w = registry.workload(cell)
    c = registry.config(w["config"])
    assert registry.traffic(w["traffic"]).setup
    assert w["settings"] in c["settings"]
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    for m in registry.cell_metrics(BENCH, cell)[1]:
        assert registry.layer_reader(m["name"]).read


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_configs_load_by_name(cfg):
    c = registry.config(cfg)
    entry = next(x for x in BENCH["configs"] if x["name"] == cfg)
    assert entry["file"] == f"benchmark/configs/{cfg}.json"
    assert entry["source"] == c["source"] and entry["reduced"] == c["reduced"]


def test_bad_names_are_refused():
    with pytest.raises(ValueError):
        registry.workload("../BENCHMARK")
    with pytest.raises(FileNotFoundError):
        registry.workload("no-such-cell")


def test_benchmark_json_follows_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                           "per_layer"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in [x["name"] for x in registry.cell_metrics(BENCH, cell)[0]]
    for cell in CELLS:
        e, layer = registry.cell_metrics(BENCH, cell)
        assert "setup_s" in [x["name"] for x in e] and len(e) >= 2 and layer
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


# ---- arithmetic against hand-worked values


def test_percentile_and_rate():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95.0
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3.0
    assert stats.rate(536_870_912, 0.5, 1e6) == pytest.approx(1073.741824)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_gaps_of_norms():
    assert stats.rel_gap(1.01, 1.0) == pytest.approx(0.01)
    gaps = stats.leaf_gaps({"a": 2.0, "b": 0.0011}, {"a": 2.0, "b": 0.001})
    # the small leaf's gap is taken over the median leaf's norm, (2 + 0.001) / 2
    assert gaps["b"] == pytest.approx(0.0001 / 1.0005)


def test_roofline_counts():
    objects = {"spheres": 54, "platforms": 1, "cylinders": 38}
    mt = registry.roofline("mega_trace")
    assert mt.ops_per_live_ray_bounce(objects) == 5338
    work = {"live_ray_bounces_per_sample": 2_492_392, "samples": 1, "rays": 1 << 20, "depth": 8,
            "hits_per_sample": 0}
    # 5,338 x 2,492,392 operations at 67 TFLOP/s: the bound PERF.md gives #1, 0.1986 ms
    assert mt.bound_s(work, objects, peaks) * 1e3 == pytest.approx(0.19857, rel=1e-4)
    mb = registry.roofline("mega_bwd")
    # 35 planes of 4 bytes a lane at 1024^2: 146.8 MB at 3.35 TB/s
    assert mb.bound_s(dict(work, hits_per_sample=1), objects, peaks) * 1e3 == pytest.approx(
        4 * (1 << 20) * 35 / 3.35e12 * 1e3)


def test_slot_counts_of_the_cells():
    cfg = registry.config("demo93")
    s = cfg["settings"]["bench"]
    assert s["width"] * s["height"] * s["spp"] * cfg["depth"] == 536_870_912
    v = cfg["settings"]["viewer"]
    assert v["width"] * v["height"] * v["spp"] * cfg["depth"] == 7_372_800
    b = registry.config("bvh16k")
    st = b["settings"]["still"]
    assert st["width"] * st["height"] * st["spp"] * b["depth"] == 134_217_728


def test_flight_follows_fly_path():
    """The flight's camera ops are `video.fly_path`'s steps, a leg with no
    keys is still, and accumulation restarts at the last move."""
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.video import fly_path

    fly = registry.traffic("progressive_flythrough")
    sch = fly.Schedule({"legs": [["wa", 2], ["", 3], ["s", 1]], "fly_step": 0.02})
    assert sch.period == 6
    assert sch.ops(0) == sch.ops(7) == fly.fly_ops("wa", 0.02)
    assert sch.ops(2) == [] and sch.ops(5) == [("move_forward", -0.02)]
    assert [sch.restart(f) for f in range(8)] == [0, 1, 1, 1, 1, 5, 6, 7]
    cam = Camera.make(16, 12, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device="cpu")
    want = fly_path(cam, 2, "wa")
    got = fly._fly(fly._fly(cam, sch.ops(0)), sch.ops(1))
    assert torch.equal(got.origin, want[-1].origin) and torch.equal(got.look_at, want[-1].look_at)


def test_trace_reduction():
    ev = [{"name": trace.WINDOW_SPAN, "ph": "X", "ts": 0.0, "dur": 1000.0,
           "cat": "user_annotation"},
          {"name": "bench.frame", "ph": "X", "ts": 0.0, "dur": 1000.0, "cat": "user_annotation"},
          {"name": "void mega_trace_kernel<false>(int)", "ph": "X", "ts": 100.0, "dur": 200.0,
           "cat": "kernel", "args": {"device": 0}},
          {"name": "elementwise", "ph": "X", "ts": 250.0, "dur": 150.0, "cat": "kernel",
           "args": {"device": 0}},
          {"name": "ncclKernel_AllReduce", "ph": "X", "ts": 500.0, "dur": 400.0, "cat": "kernel",
           "args": {"device": 0}}]
    r = trace.reduce_events(ev, 0.001)
    assert r["busy_s"] == pytest.approx(300e-6)  # [100, 400] merged; NCCL left out
    assert r["ops"]["mega_trace_kernel"] == pytest.approx(200e-6)
    assert r["idle_gaps"][0] == ["bench.frame", pytest.approx(600e-6)]
    assert trace.function_of("void bvh_winner_kernel<true>(float const*)") == "bvh_winner_kernel"


# ---- the result line and the runs


def check_line(line: dict, cell: str, traced: bool):
    assert list(line)[:5] == CONTRACT_KEYS and list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["kind"] == "cpu"
    e2e, layer = registry.cell_metrics(BENCH, cell)
    if traced:
        assert "busy_s" in dev and "window_s" in dev and "breakdown" in line
        # no device ran: no CPU number under a device metric
        assert line["metrics"] == {} and dev["busy_s"] == 0.0
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
        for m in e2e:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu_at_a_toy_size(cell, traced):
    ctx = tiny(cell, trace_on=traced)
    line = runner.run_cell(ctx, 0.0, BENCH)
    check_line(line, cell, traced)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_rejected(cell):
    """The reference in bfloat16, put in the program's place, fails the
    cell's limits."""
    ctx, kind, st, _ = run_tiny(cell)
    got, judged, _ = kind.compared(st, ctx, control=torch.bfloat16)
    assert judged and over_limit(got, ctx.workload["params"]["limits"]), got


def _train_faults():
    from cpppathtracer_tpu_torch import inverse

    def half_batch(camera, cfg, optimizer, params, opt, scene, sky_tex, target, sample_offset):
        scene = scene.with_material_params({**scene.material_params(), **params["mat"]})
        rad = inverse.render_for_loss(scene, camera, sky_tex, cfg, sample_offset)
        n = rad.shape[0] // 2
        loss = torch.mean((rad[:n] - target[:n]) ** 2)
        grads = iter(torch.autograd.grad(loss, list(inverse.tensors(params))))
        optimizer.update(params, inverse.map_tensors(params, lambda _: next(grads)), opt)
        return loss.detach()

    return {"half_batch": (inverse, "_step", half_batch)}


def _altered_render():
    from cpppathtracer_tpu_torch import integrator

    real = integrator.render_radiance_jit
    def altered(*a, **k):
        rad, n0, t0 = real(*a, **k)
        return rad * 1.01, n0, t0

    return {"answer_altered": (integrator, "render_radiance_jit", altered)}


def _altered_frame():
    from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer

    real = ProgressiveRenderer.step
    return {"answer_altered": (ProgressiveRenderer, "step", lambda self: real(self) * 0.99 + 0.005)}


def _mesh_faults():
    """Tiles of the mesh left out of the sharded loss and its gradients: all
    but the first card's (their exchange left out), or half of them (half
    the batch, the mean over the rest)."""
    from cpppathtracer_tpu_torch.parallel import render

    real = render._tile_slices
    return {"exchange_left_out": (render, "_tile_slices", lambda m, g: real(m, g)[:1]),
            "half_batch": (render, "_tile_slices", lambda m, g: real(m, g)[:len(real(m, g)) // 2])}


FAULTS = {"demo93-train": _train_faults, "bvh16k-still": _altered_render,
          "demo93-progressive": _altered_frame, "demo93-mesh4-train": _mesh_faults}


@pytest.mark.parametrize("cell,fault", [
    ("demo93-train", "state_unchanged"), ("demo93-train", "half_batch"),
    ("bvh16k-still", "answer_altered"), ("demo93-progressive", "answer_altered"),
    ("demo93-mesh4-train", "state_unchanged"), ("demo93-mesh4-train", "half_batch"),
    ("demo93-mesh4-train", "exchange_left_out")])
def test_planted_fault_is_rejected(cell, fault, monkeypatch):
    """A run whose timed path is broken underneath comes out not correct."""
    if fault == "state_unchanged":
        # Adam with its update removed, taking the learning rate as adam() passes it
        from cpppathtracer_tpu_torch import inverse

        monkeypatch.setattr(inverse, "adam", lambda lr: inverse.Optimizer(
            inverse.adam_init, lambda params, grads, state: None))
    else:
        obj, name, fn = FAULTS[cell]()[fault]
        monkeypatch.setattr(obj, name, fn)
    line = runner.run_cell(tiny(cell), 0.0, BENCH)
    assert line["correct"] is False, line["checks"]


# ---- the no-card exit and the no-JAX check


def test_no_jax_names_are_caught():
    assert runner.forbidden_modules(["jax.numpy", "cpppathtracer_tpu_torch.ops", "numpy",
                                     "cpppathtracer_tpu.ops.bvh", "jaxlib"]) == [
        "cpppathtracer_tpu", "jax", "jaxlib"]
    assert runner.forbidden_modules(["cpppathtracer_tpu_torch", "jaxtyping_not"]) == []


def test_a_run_loads_no_jax():
    """A toy run in a fresh process leaves neither JAX nor the JAX package in
    sys.modules."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests.test_bench_harness import tiny\n"
            "from benchmark.harness import runner, registry\n"
            "runner.run_cell(tiny('demo93-progressive'), 0.0, registry.benchmark())\n"
            "print(runner.forbidden_modules())\n") % str(ROOT)
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a card run.py exits with an error and prints nothing on
    standard output (no CPU number under a device metric)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_judge_counts_nan_as_a_mismatch():
    got = torch.tensor([[1.0, 2.0, 3.0], [float("nan"), 0.0, 0.0]])
    want = torch.tensor([[1.0, 2.0, 3.0], [1.0, 0.0, 0.0]])
    assert judge.mismatch_share(got, want, 1e-4) == 0.5
    assert judge.finite(math.nan) == judge.NOT_A_NUMBER


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "demo93-progressive",
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == CONTRACT_KEYS and line["device"]["platform"] == "gpu"
    assert line["correct"] is True
