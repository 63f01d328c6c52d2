"""Tests of the benchmark's albedo textures: a configuration's stack and
its checks, the plain reference's UV, bilinear fetch and stack gradient,
the guard that keeps a textured configuration from rendering untextured,
the readers of the textured cell's per-layer metrics, and the cell
`demo93-textured-train` at a toy size on the CPU, with the faults its
comparison must reject planted in the program.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import math
import re
import sys
from pathlib import Path

import numpy as np

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import inputs, peaks, registry, runner, trace  # noqa: E402
from benchmark.reference import scenes, textured, tracer, training  # noqa: E402
from benchmark.tests.test_bench_harness import BENCH, run_tiny, tiny  # noqa: E402

CELL = "demo93-textured-train"
TEXTURED = registry.config("demo93-textured")


def _scene(tex_id):
    a = scenes.demo_scene(0)
    a["tex_id"] = np.asarray(tex_id, np.int32)
    return a


# ---- a configuration's stack and its checks


@pytest.mark.parametrize("bad,textures", [
    ("a texture without a stack", 0), ("a tex_id past the stack", 2), ("a tex_id under -1", 2)])
def test_check_scene_refuses_textures_out_of_range(bad, textures):
    n = len(scenes.demo_scene(0)["prim_type"])
    tid = np.full(n, -1)
    tid[3] = {"a texture without a stack": 0, "a tex_id past the stack": 2,
              "a tex_id under -1": -2}[bad]
    with pytest.raises(ValueError, match="scenes/own.py: a tex_id"):
        scenes.check_scene(_scene(tid), "scenes/own.py", textures)


def test_check_scene_takes_tex_ids_within_the_stack():
    n = len(scenes.demo_scene(0)["prim_type"])
    tid = np.arange(n) % 3 - 1  # -1, 0, 1
    assert scenes.check_scene(_scene(tid), "x", 2)["tex_id"] is not None
    assert (scenes.check_scene(scenes.demo_scene(0), "x", 2)["tex_id"] == -1).all()


BAD_STACKS = {
    "float64": lambda t: t.astype(np.float64),
    "one texture without its axis": lambda t: t[0],
    "no texture": lambda t: t[:0],
    "four channels": lambda t: np.concatenate([t, t[..., :1]], axis=-1),
    "a negative texel": lambda t: np.where(np.arange(t.size).reshape(t.shape) == 5, -0.1, t),
    "a NaN": lambda t: np.where(np.arange(t.size).reshape(t.shape) == 5, np.nan, t),
    "an infinity": lambda t: np.where(np.arange(t.size).reshape(t.shape) == 5, np.inf, t),
}


@pytest.mark.parametrize("bad", BAD_STACKS)
def test_check_textures_refuses(bad):
    good = np.full((2, 4, 5, 3), 0.5, np.float32)
    scenes.check_textures(good, "x")
    tex = BAD_STACKS[bad](good)
    if tex.dtype == np.float64 and bad != "float64":
        tex = tex.astype(np.float32)
    with pytest.raises(ValueError, match="scenes/own.py: a texture"):
        scenes.check_textures(tex, "scenes/own.py")


def test_textured_configuration_gives_both_sides_its_stack():
    ctx = tiny(CELL)
    tex = inputs.textures(ctx)
    assert tex.shape == (2, 256, 256, 3) and tex.dtype == np.float32
    arr, _ = inputs.arrays(ctx)
    pt = arr["prim_type"]
    assert (arr["tex_id"][pt == scenes.PLATFORM] == 0).all()
    assert (arr["tex_id"][pt == scenes.CYLINDER] == 1).all()
    assert (arr["tex_id"][pt == scenes.SPHERE] == -1).all()
    assert (pt == scenes.CYLINDER).sum() == 38 and (pt == scenes.SPHERE).sum() == 54
    prog = inputs.program_inputs(ctx)
    assert torch.equal(prog["tex_stack"], torch.from_numpy(tex))
    assert torch.equal(prog["scene"].tex_id, torch.from_numpy(arr["tex_id"]))
    ref = inputs.reference_inputs(ctx, torch.float32)
    assert torch.equal(ref["tex_stack"], torch.from_numpy(tex)) and ref["scene"].textured
    # the checker of 32-texel squares and the frozen sky at seed 1
    assert tex[0, 0, 0].tolist() == pytest.approx([0.2, 0.3, 0.7])
    assert tex[0, 0, 32].tolist() == pytest.approx([0.9, 0.8, 0.3])
    assert np.array_equal(tex[1], scenes.procedural_sky(256, 256, seed=1))
    untextured = tiny("demo93-train")
    assert inputs.textures(untextured) is None
    assert inputs.program_inputs(untextured)["tex_stack"] is None


@pytest.mark.parametrize("cell", ["bvh16k-still", "demo93-progressive", "demo93-train",
                                  "demo93-mesh4-train"])
def test_a_textured_configuration_needs_a_traffic_that_passes_textures(cell, monkeypatch):
    """Every traffic kind that does not declare TEXTURES stops at set-up on
    a textured configuration, naming the files, and never renders it
    untextured."""
    real = registry.workload
    wl = real(cell)
    monkeypatch.setattr(registry, "workload",
                        lambda name: dict(wl, config="demo93-textured") if name == cell
                        else real(name))
    kind = wl["traffic"]
    with pytest.raises(ValueError, match=re.escape(
            f"benchmark/configs/demo93-textured.json brings textures and "
            f"benchmark/traffic/{kind}.py does not declare")):
        runner.make_context(cell, 5, 0.1, False, [torch.device("cpu")] * int(wl["chips"]))


def test_grad_loop_refuses_an_untextured_configuration(monkeypatch):
    real = registry.workload
    monkeypatch.setattr(registry, "workload",
                        lambda name: dict(real(CELL), config="demo93") if name == CELL
                        else real(name))
    ctx = runner.make_context(CELL, 5, 0.1, False, [torch.device("cpu")])
    ctx.settings.update(width=16, height=12)
    with pytest.raises(ValueError, match="configs/demo93.json brings none"):
        registry.traffic("grad_loop").setup(ctx)


# ---- the reference's UV, fetch and gradient


def test_bilinear_mirror_addressing_at_the_edges():
    """Taps past an edge mirror back onto the texture: at u = 0 (x = -0.5)
    the taps are texels -1 and 0, which are both texel 0; at u = 1 (x =
    W - 0.5) texels W - 1 and W, both texel W - 1; clamping agrees there
    and parts from mirroring a texel further out."""
    h, w = 2, 3
    vals = torch.arange(h * w, dtype=torch.float64).reshape(h, w, 1).expand(h, w, 3)
    stack = torch.stack([vals, 10.0 + vals])
    fetch = lambda t, u, v, a="mirror": textured.bilinear(
        stack, torch.tensor([t]), torch.tensor([u], dtype=torch.float64),
        torch.tensor([v], dtype=torch.float64), a)[0, 0].item()
    # texel centres: (x + 0.5) / W, (y + 0.5) / H
    assert fetch(0, 0.5 / w, 0.5 / h) == pytest.approx(0.0, abs=1e-12)
    assert fetch(1, 2.5 / w, 1.5 / h) == pytest.approx(15.0)
    assert fetch(0, 0.0, 0.25) == 0.0  # x = -0.5: taps -1 and 0 are both texel 0
    assert fetch(0, 1.0, 0.25) == 2.0  # x = 2.5: taps 2 and 3 are both texel 2
    assert fetch(0, 0.5 / w, 1.0) == pytest.approx(3.0)  # y = 1.5: taps 1 and 2 are both row 1
    # x = -1.5: taps -2, -1 mirror to texels 1 and 0, weights 0.5 / 0.5
    assert fetch(0, -1.0 / w, 0.25) == pytest.approx(0.5)
    # halfway between rows 0 and 1 of column 1: (1 + 4) / 2
    assert fetch(0, 1.5 / w, 0.5) == pytest.approx(2.5)
    # u = 4/3 (x = 3.5): taps 3 and 4 mirror to 2 and 1, weights 0.5 / 0.5
    assert fetch(0, 4.0 / 3.0, 0.25) == pytest.approx(1.5)
    assert fetch(0, 4.0 / 3.0, 0.25, "clamp") == 2.0
    # texture 1 is texture 0 plus 10
    assert fetch(1, 1.0, 0.25) == 12.0


def test_surface_uv_follows_the_definition():
    f = lambda *v: torch.tensor(v, dtype=torch.float64)
    prim = torch.tensor([0, 1, 2, 2])
    center = (f(1.0, 0.0, 0.0, 0.0), f(2.0, 0.0, 1.0, 0.0), f(3.0, 0.0, 0.0, 0.0))
    radius, height = f(2.0, 0.0, 1.0, 0.0), f(0.0, 0.0, 4.0, 0.0)
    pos = (f(1.0, 150.0, 0.0, 1.0), f(4.0, 0.0, 0.0, 0.5), f(3.0, -50.0, 1.0, 0.0))
    u, v = textured.surface_uv(prim, center, radius, height, pos)
    # sphere: straight up from its centre; platform: 0.01 p.x, 0.01 p.z;
    # cylinder: a quarter turn, a quarter of the way up; zero height taken as 1
    assert u.tolist() == pytest.approx([0.5, 1.5, 0.75, 0.5])
    assert v.tolist() == pytest.approx([1.0, -0.5, 0.25, 0.5])


def _toy_paths(dtype=torch.float64):
    ctx = tiny(CELL)
    ref = inputs.reference_inputs(ctx, dtype)
    pix = torch.arange(16 * 12, dtype=torch.int32)
    paths, _ = training.trace_samples(ref["scene"], ref["camera"], ref["sky"], pix, 0, 2, 3,
                                      offset=0)
    return ctx, ref, paths


def test_reference_records_hit_positions_on_textured_scenes_only():
    _, ref, paths = _toy_paths(torch.float32)
    assert paths[0].pos.shape == (3, 3, 16 * 12)
    hit = paths[0].objs >= 0
    size = paths[0].pos.abs().sum(1)
    assert (size[~hit] == 0).all() and (size[hit] > 0).any()
    plain = inputs.reference_inputs(tiny("demo93-train"), torch.float32)
    pix = torch.arange(8, dtype=torch.int32)
    p = tracer.trace(plain["scene"], plain["camera"], plain["sky"], pix, torch.zeros_like(pix), 0,
                     3, record=True)
    assert p.pos is None and not plain["scene"].textured


def test_stack_gradient_matches_finite_differences():
    """The reference's gradient of sum(rad^2) with respect to texels, in
    float64, against central differences of its own loss: the recorded
    paths fix the geometry, so the loss is smooth in the stack."""
    _, ref, paths = _toy_paths()
    scene = ref["scene"]
    kd, em = scene.kd.clone(), scene.emission.clone()
    stack = ref["tex_stack"].clone()
    loss, _, _, g = textured.loss_and_grads(scene, paths, kd, em, stack)
    flat = g.flatten()
    picks = torch.topk(flat.abs(), 6).indices.tolist() + [int(torch.nonzero(flat)[0])]
    eps = 1e-6

    def loss_at(i, h):
        s = stack.clone().flatten()
        s[i] += h
        img = textured.image(scene, paths, kd, em, s.reshape(stack.shape))
        return float((img * img).sum())

    for i in picks:
        fd = (loss_at(i, eps) - loss_at(i, -eps)) / (2 * eps)
        assert fd == pytest.approx(float(flat[i]), rel=1e-6, abs=1e-12), i
    assert float(loss) == pytest.approx(loss_at(0, 0.0), rel=1e-14)


def test_port_step_matches_the_reference_on_the_cpu():
    """The port's `bench.train_step` with a stack against the reference's
    loss and gradients at a toy size (16x12, 2 spp, depth 3)."""
    from cpppathtracer_tpu_torch import bench

    ctx = tiny(CELL)
    kind = registry.traffic("grad_loop")
    st = kind.setup(ctx)
    loss, grads = bench.train_step(*st.args)
    want = kind.reference_readings(ctx, torch.float32)
    assert float(loss) == pytest.approx(want["loss"], rel=1e-5)
    for k in kind.LEAVES:
        assert grads[k].shape == want["grads"][k].shape
        torch.testing.assert_close(grads[k].double(), want["grads"][k], rtol=1e-4,
                                   atol=1e-5 * float(want["grads"][k].abs().max()))
    assert float(want["grads"]["tex_stack"].abs().sum()) > 0


# ---- the cell's faults, planted in the program


def _program_faults():
    from cpppathtracer_tpu_torch import bench, integrator
    from cpppathtracer_tpu_torch.ops import texture

    real_step = bench.train_step
    real_kd = integrator._textured_kd

    def no_texture(tex_id, geom_p, pos, stack, kd):
        # the albedo kd; the stack kept in the graph, with a zero gradient
        return tuple(k + 0.0 * t for k, t in zip(kd, real_kd(tex_id, geom_p, pos, stack, kd)))

    def half_batch(scene, camera, sky, spp, max_depth, tex_stack=None):
        leaves = {"kd": scene.kd.clone().requires_grad_(),
                  "emission": scene.emission.clone().requires_grad_(),
                  "tex_stack": tex_stack.clone().requires_grad_()}
        s = scene.with_material_params({"kd": leaves["kd"], "emission": leaves["emission"]})
        rad, _, _ = integrator.render_radiance(s, camera, sky, spp=spp, max_depth=max_depth,
                                               seed=0, tex_stack=leaves["tex_stack"])
        n = rad.shape[0] // 2
        loss = (rad[:n] * rad[:n]).sum() * 2.0
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def altered(*a, **k):
        loss, grads = real_step(*a, **k)
        return loss, {n: g * 1.01 if n == "tex_stack" else g for n, g in grads.items()}

    return {
        "no_texture": (integrator, "_textured_kd", no_texture),
        "clamp_taps": (texture, "_mirror_index", lambda i, n: torch.clamp(i, 0, n - 1)),
        "half_batch": (bench, "train_step", half_batch),
        "answer_altered": (bench, "train_step", altered),
    }


@pytest.mark.parametrize("fault", ["no_texture", "clamp_taps", "half_batch", "answer_altered"])
def test_planted_fault_is_rejected(fault, monkeypatch):
    obj, name, fn = _program_faults()[fault]
    monkeypatch.setattr(obj, name, fn)
    line = runner.run_cell(tiny(CELL), 0.0, BENCH)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", textured.FAULTS)
def test_reference_fault_is_rejected(fault):
    """Each fault the readings plant in the reference fails the cell's
    limits at the toy size."""
    ctx, kind, st, _ = run_tiny(CELL, iterations=2)
    got, _, _ = kind.compared(st, ctx, control=fault)
    lim = ctx.workload["params"]["limits"]
    assert any(not v <= lim[k] for k, v in got.items()), got


# ---- the readers of the textured cell


def _view(names: dict, config: dict, samples: int = 4):
    ops = {}
    for n, s in names.items():
        ops[trace.function_of(n)] = ops.get(trace.function_of(n), 0.0) + s
    reduced = {"busy_s": 1.0, "window_s": 1.1, "cards": 1, "ops": ops, "names": names}
    work = {"samples": samples, "rays": samples * (1 << 20), "pixels": 1 << 20, "depth": 8}
    wl = {"counts": {"live_ray_bounces_per_sample": 2.5e6, "hits_per_sample": 1.46e6,
                     "aux_planes_per_bounce": 4, "aux_ops_per_hit": 4}}
    return trace.TraceView(reduced, work, config, wl, registry.roofline, peaks)


NAMES = {
    "void at::native::indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, true, "
    "at::native::ReduceAdd>(at::cuda::detail::TensorInfo<float, unsigned int>)": 0.2,
    "void at::native::indexFuncSmallIndex<float, long, unsigned int, 1, 1, -2>(int)": 0.04,
    "void at::native::indexFuncLargeIndex<double, long, unsigned int, 2, 2, -2, true, "
    "at::native::ReduceAdd>(at::cuda::detail::TensorInfo<double, unsigned int>)": 0.3,
    "void mega_bwd_kernel<true, true>(float const*)": 0.008,
    "void at::native::elementwise_kernel<128, 2>(float)": 0.5,
}


def test_texture_taps_ms_reads_the_float_index_adds():
    read = registry.layer_reader("texture_taps_ms").read
    assert read(_view(NAMES, TEXTURED)) == pytest.approx(1e3 * 0.24 / 4)
    assert read(_view(NAMES, registry.config("demo93"))) is None
    assert read(_view({k: v for k, v in NAMES.items() if "<float" not in k}, TEXTURED)) is None


def test_mega_bwd_roofline_counts_the_aux_planes_of_a_textured_cell():
    """One bound for #8's two instances: a cell's `counts` add the textured
    instance's aux cotangent planes and operations, none where absent."""
    rf = registry.roofline("mega_bwd")
    work = {"rays": 1 << 20, "depth": 8, "hits_per_sample": 1, "samples": 1}
    aux = dict(work, aux_planes_per_bounce=4, aux_ops_per_hit=4)
    # #8's 35 planes, and the 32 aux cotangent planes besides: 281.0 MB at 1024^2 x d8
    assert 4 * (1 << 20) * (35 + 32) == pytest.approx(281.0e6, rel=2e-4)
    assert rf.bound_s(work, {}, peaks) == pytest.approx(4 * (1 << 20) * 35 / peaks.HBM_BYTES_PER_S)
    assert rf.bound_s(aux, {}, peaks) == pytest.approx(4 * (1 << 20) * 67 / peaks.HBM_BYTES_PER_S)
    ops = lambda w: dict(w, hits_per_sample=1e9)
    assert rf.bound_s(ops(work), {}, peaks) == pytest.approx(958 * 1e9 / peaks.FP32_FLOPS)
    assert rf.bound_s(ops(aux), {}, peaks) == pytest.approx((958 + 4) * 1e9 / peaks.FP32_FLOPS)
    reader = registry.layer_reader("mega_bwd_roofline")
    view = _view(NAMES, TEXTURED)
    bound = rf.bound_s(view.counted_work(), TEXTURED["objects"], peaks)
    assert view.counted_work()["aux_planes_per_bounce"] == 4
    assert reader.read(view) == pytest.approx(100.0 * bound / 0.008)
    assert math.isfinite(reader.read(view)) and 0 < reader.read(view) <= 100
    assert reader.read(_view({k: v for k, v in NAMES.items() if "mega_bwd" not in k}, TEXTURED)) is None
