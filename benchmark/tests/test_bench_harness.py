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

import hashlib
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import inputs, judge, peaks, registry, runner, stats, trace  # noqa: E402
from benchmark.reference import scenes  # noqa: E402

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(cell: str, seed: int = 2**31 + 77, trace_on: bool = False):
    """The cell's context cut to a toy size on the CPU: 16x12 pixels, 2
    samples, depth 3, big scenes at 2048 objects (still past the BVH
    threshold), short flythroughs, every pixel checked (a cell checks 256
    or more: on a sample of a few dozen one path that the walk and the
    reference's dense search split at an exact tie, as a glass cylinder's
    base and the floor at y = 0, weighs more than a cell's limits
    allow)."""
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
        p["check_pixels"] = 16 * 12
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
    s = runner.cell_settings(w, c)
    assert sorted(s) == sorted(runner.SETTINGS)
    if isinstance(w["settings"], str):
        assert s == c["settings"][w["settings"]]
    else:
        assert s == w["settings"]
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
    # a cell's own settings: the BVH viewer at the demo viewer's size
    f = runner.cell_settings(registry.workload("bvh16k-progressive"), b)
    assert f["width"] * f["height"] * f["spp"] * b["depth"] == 7_372_800


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


# ---- the inputs: the frozen built-ins, and what a configuration brings in files of its own


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for k, a in arrays:
        a = np.ascontiguousarray(a)
        h.update(k.encode() + str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("what,make,digest", [
    ("demo_scene(0)", lambda: scenes.demo_scene(0),
     "19722e0354adce4a99cd3a0cb6e7b95e3775435c0b9fb24eda6e081e6f245508"),
    ("big_scene(16384, 7)", lambda: scenes.big_scene(16384, 7),
     "4fb8ad22612e00309b150fd2d8f0c4342f23dde2f41086774e56726e52f19122"),
    ("procedural_sky(256, 256, 0)", lambda: {"": scenes.procedural_sky(256, 256, 0)},
     "48ab43b584ae8c810c16d8cbdee3f362ddb3e33d6b7457b70925beaebdc2083a")])
def test_frozen_inputs_keep_their_bytes(what, make, digest):
    """The built-in scenes and sky, which every cell so far is made from,
    give the bytes they gave when their cells' limits were read."""
    got = make()
    order = scenes.FIELDS if set(got) == set(scenes.FIELDS) else got
    assert _digest((k, got[k]) for k in order) == digest, what


def test_frozen_inputs_pass_their_checks():
    for entry in BENCH["configs"]:
        cfg = registry.config(entry["name"])
        tex = inputs.make_textures(cfg["textures"]) if "textures" in cfg else None
        inputs.make_scene(cfg["scene"], 0 if tex is None else tex.shape[0])
        inputs.make_sky(cfg["sky"])
    assert scenes.make_camera({"generator": "big_camera", "n": 16384}) == dict(
        scenes.big_camera(16384), lens_radius=5e-4)


@pytest.mark.parametrize("settings,want", [
    ("still", {"width": 1024, "height": 1024, "spp": 16}),
    ({"width": 64, "height": 48, "spp": 3}, {"width": 64, "height": 48, "spp": 3})])
def test_named_and_own_settings_resolve(settings, want):
    cfg = registry.config("bvh16k")
    assert runner.cell_settings({"name": "x", "settings": settings}, cfg) == want


@pytest.mark.parametrize("settings", [
    "no_such_setting", {"width": 64, "height": 48}, {"width": 64, "height": 48, "spp": 0},
    {"width": 64.0, "height": 48, "spp": 1}, {"width": 64, "height": 48, "spp": 1, "depth": 2}])
def test_bad_settings_are_refused(settings):
    with pytest.raises((KeyError, ValueError), match="workloads/x.json"):
        runner.cell_settings({"name": "x", "settings": settings}, registry.config("bvh16k"))


OWN_GENERATOR = """
import numpy as np

from benchmark.reference.scenes import Objects


def scene(count=6, seed=1):
    rng = np.random.default_rng(seed)
    b = Objects()
    b.platform(0.0, kd=(0.8, 0.8, 0.8))
    for i in range(count):
        b.sphere((float(rng.uniform(-4, 4)), 1.0, float(rng.uniform(-4, 4))), 1.0, mat_type=i % 4,
                 kd=tuple(rng.uniform(0.2, 1.0, 3)), smoothness=2.0, reflectivity=0.3,
                 emission=2.0 if i == 0 else 0.0)
    return b.arrays()


def sky(height=8, width=16, top=(0.5, 0.7, 1.0)):
    t = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    grad = (1.0 - t) + t * np.array(top, np.float32)
    return np.ascontiguousarray(np.broadcast_to(grad, (height, width, 3)), dtype=np.float32)
"""


def _tree(tmp_path, monkeypatch, modules: dict):
    """A benchmark directory in tmp_path that holds the benchmark's own
    traffic kinds, readers and rooflines and the given scene files, and
    that the registry looks in."""
    for d in ("traffic", "layers", "roofline"):
        (tmp_path / d).symlink_to(registry.BENCH_DIR / d)
    for d in ("configs", "workloads", "scenes"):
        (tmp_path / d).mkdir()
    for name, text in modules.items():
        (tmp_path / "scenes" / f"{name}.py").write_text(text)
    monkeypatch.setattr(registry, "BENCH_DIR", tmp_path)
    return tmp_path


def _files_of(root: Path) -> dict:
    return {str(f.relative_to(root)): f.read_bytes() for f in sorted(root.rglob("*"))
            if f.is_file() and "__pycache__" not in f.parts}


@pytest.mark.parametrize("traffic", ["still_renders", "progressive_flythrough"])
def test_a_configuration_brings_its_own_scene_sky_lens_and_settings(traffic, tmp_path,
                                                                    monkeypatch):
    """A configuration and a cell added as new files alone, with a scene
    and a sky of their own, a lens radius and the cell's own settings, run
    through `run_cell` at a toy size on the CPU and come out correct; no
    file under benchmark/ changes."""
    before = _files_of(registry.BENCH_DIR)
    tree = _tree(tmp_path, monkeypatch, {"own_scene_test": OWN_GENERATOR})
    cfg = {"name": "own-scene", "source": "a test's own scene",
           "scene": {"generator": "own_scene_test", "args": {"count": 6, "seed": 3}},
           "objects": {"spheres": 6, "platforms": 1, "cylinders": 0},
           "sky": {"generator": "own_scene_test", "args": {"height": 8, "width": 16}},
           "camera": {"origin": [0.0, 3.0, 12.0], "look_at": [0.0, 1.0, 0.0], "view_fov": 40.0,
                      "lens_radius": 0.05},
           "depth": 3, "bvh": False, "precision": "float32", "reduced": [], "search": "expanded"}
    params = {"check_pixels": 32, "pixel_tolerance": 1e-4,
              "limits": {"pixel_mismatch_share": 0.1, "rel_l1": 0.03}}
    params.update({"check_renders": 2} if traffic == "still_renders" else
                  {"legs": [["w", 3], ["", 2]], "fly_step": 0.02, "check_frames": 3})
    cell = f"own-scene-{traffic}"
    wl = {"name": cell, "config": "own-scene", "traffic": traffic,
          "settings": {"width": 16, "height": 12, "spp": 2}, "chips": 1, "why": "a test",
          "trace_iterations": 3, "params": params, "counts": {}}
    (tree / "configs" / "own-scene.json").write_text(json.dumps(cfg))
    (tree / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    torch.set_num_threads(2)
    ctx = runner.make_context(cell, 2**31 + 5, 0.2, False, [torch.device("cpu")])
    assert ctx.settings == wl["settings"]
    arr, sky = inputs.arrays(ctx)
    assert len(arr["prim_type"]) == 7 and sky.shape == (8, 16, 3)
    assert float(inputs.program_inputs(ctx)["camera"].lens_radius) == pytest.approx(0.05)
    bench = {"end_to_end": [{"name": "render_Mrays_s", "unit": "Mrays/s", "workloads": [cell]},
                            {"name": "setup_s", "unit": "s"}], "per_layer": []}
    line = runner.run_cell(ctx, 0.0, bench)
    assert line["correct"] and set(line["metrics"]) == {"render_Mrays_s", "setup_s"}, line
    assert _files_of(registry.ROOT / "benchmark") == before


@pytest.mark.parametrize("cell", ["demo93-progressive", "bvh16k-progressive"])
@pytest.mark.parametrize("lens", [None, 0.05])
def test_lens_radius_reaches_both_cameras(cell, lens):
    """The configuration's lens radius (5e-4 where it gives none) reaches the
    program's camera, the reference's, and the reference's poses of the
    flight."""
    ctx = tiny(cell)
    if lens is not None:
        ctx.config["camera"]["lens_radius"] = lens
    want = 5e-4 if lens is None else lens
    prog = inputs.program_inputs(ctx)["camera"]
    assert prog.lens_radius.item() == pytest.approx(want, rel=1e-7)
    assert inputs.reference_inputs(ctx, torch.float32)["camera"].lens.item() == pytest.approx(
        want, rel=1e-7)
    pose = registry.traffic("progressive_flythrough").flight_poses(ctx, 2)[1]
    assert pose[3] == want
    assert inputs.reference_inputs(ctx, torch.float32, pose=pose)["camera"].lens.item() == (
        pytest.approx(want, rel=1e-7))


BAD_SCENES = {
    "a_key_missing": "a.pop('ior')",
    "a_key_too_many": "a['uv'] = a['kd']",
    "a_wrong_dtype": "a['prim_type'] = a['prim_type'].astype(np.int64)",
    "a_row_missing": "a['center'] = a['center'][:-1]",
    "no_objects": "a = {k: v[:0] for k, v in a.items()}",
    "an_unknown_kind": "a['prim_type'][0] = 3",
    "an_unknown_material": "a['mat_type'][0] = 4",
    "a_texture": "a['tex_id'][0] = 0",
    "a_value_not_finite": "a['radius'][1] = np.nan",
    "not_a_dict": "a = list(a.values())",
}
BAD_SKIES = {
    "a_sky_of_one_channel": "s = s[..., 0]",
    "a_sky_of_float64": "s = s.astype(np.float64)",
    "a_negative_sky": "s[0, 0, 0] = -1.0",
}


@pytest.mark.parametrize("bad", [*BAD_SCENES, *BAD_SKIES, "no_function", "no_file"])
def test_a_bad_generator_is_refused_naming_its_file(bad, tmp_path, monkeypatch):
    part = "sky" if bad in BAD_SKIES else "scene"
    name = f"bad_{bad}"
    if bad in BAD_SCENES:
        text = OWN_GENERATOR.replace("    return b.arrays()",
                                     f"    a = b.arrays()\n    {BAD_SCENES[bad]}\n    return a")
    elif bad in BAD_SKIES:
        text = OWN_GENERATOR.replace("    return np.ascontiguousarray(", "    s = np.array(") + (
            f"\n    {BAD_SKIES[bad]}\n    return s\n")
    else:
        text = "import numpy as np\n"
    tree = _tree(tmp_path, monkeypatch, {} if bad == "no_file" else {name: text})
    path = str(tree / "scenes" / f"{name}.py")
    spec = {"generator": name, "args": {}}
    make = inputs.make_sky if part == "sky" else inputs.make_scene
    with pytest.raises((ValueError, FileNotFoundError), match=re.escape(path)):
        make(spec)


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


def _frame_faults():
    """A frame altered where it is produced, or the viewer's first frame
    shown again for every later one (its state unchanged)."""
    from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer

    real = ProgressiveRenderer.step
    first = {}

    def unchanged(self):
        img = real(self)
        return first.setdefault(id(self), img.clone())

    return {"answer_altered": (ProgressiveRenderer, "step", lambda self: real(self) * 0.99 + 0.005),
            "state_unchanged": (ProgressiveRenderer, "step", unchanged)}


def _mesh_faults():
    """Tiles of the mesh left out of the sharded loss and its gradients: all
    but the first card's (their exchange left out), or half of them (half
    the batch, the mean over the rest)."""
    from cpppathtracer_tpu_torch.parallel import render

    real = render._tile_slices
    return {"exchange_left_out": (render, "_tile_slices", lambda m, g: real(m, g)[:1]),
            "half_batch": (render, "_tile_slices", lambda m, g: real(m, g)[:len(real(m, g)) // 2])}


FAULTS = {"demo93-train": _train_faults, "bvh16k-still": _altered_render,
          "demo93-progressive": _frame_faults, "demo93-mesh4-train": _mesh_faults,
          "bvh16k-progressive": _frame_faults}


@pytest.mark.parametrize("cell,fault", [
    ("demo93-train", "state_unchanged"), ("demo93-train", "half_batch"),
    ("bvh16k-still", "answer_altered"), ("demo93-progressive", "answer_altered"),
    ("bvh16k-progressive", "answer_altered"), ("demo93-progressive", "state_unchanged"),
    ("bvh16k-progressive", "state_unchanged"),
    ("demo93-mesh4-train", "state_unchanged"), ("demo93-mesh4-train", "half_batch"),
    ("demo93-mesh4-train", "exchange_left_out")])
def test_planted_fault_is_rejected(cell, fault, monkeypatch):
    """A run whose timed path is broken underneath comes out not correct."""
    if fault == "state_unchanged" and cell.endswith("-train"):
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
