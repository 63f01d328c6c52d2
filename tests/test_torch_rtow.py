"""The `rtow_final` preset: the final render of "Ray Tracing in One Weekend"
(book 1, v3.2.3, section 13.1) on the port's dense megakernel path, held
on the CPU against the benchmark's own frozen generator and its plain
reference (`benchmark/scenes/rtow_final.py`, `benchmark/reference/`), which
import nothing of the port.

Tolerances, and why:
- the scene and the sky: equal, bit for bit (the two generators run the
  same float64 arithmetic and the same draws, then round once to float32);
- the render: the benchmark's own `pixel_tolerance`, 1e-4 of max(1, |ref|)
  per pixel, on every pixel, and no pixel past it (the port's plain
  megakernel and the reference round each float32 operation alike, so a
  path that took the same winners at every bounce differs only in the
  order of the sum over samples);
- the winners: equal at every bounce of every path;
- the sky at texel centres: 2e-6 absolute (the lookup's float32 asin and
  atan put the centre's coordinates within a few ulps of the texel, so the
  bilinear weights are within about 1e-6 of (1, 0)).
"""

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cpppathtracer_tpu_torch import __main__ as cli
from cpppathtracer_tpu_torch import integrator
from cpppathtracer_tpu_torch.models import presets
from cpppathtracer_tpu_torch.ops import fast, texture
from cpppathtracer_tpu_torch.ops.mega import mega_sample
from cpppathtracer_tpu_torch.types import MaterialType

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import judge  # noqa: E402
from benchmark.reference import tracer  # noqa: E402
from benchmark.scenes import rtow_final as bench_rtow  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("prim_type", "center", "radius", "y_pos", "height", "mat_type", "kd", "emission",
          "smoothness", "reflectivity", "ior", "tex_id")
PIXEL_TOLERANCE = 1e-4  # benchmark/workloads/rtow-final-still.json's pixel_tolerance
SEED = 2**31 + 23


def _arrays(scene) -> dict:
    return {k: getattr(scene, k).numpy() for k in FIELDS}


@pytest.mark.parametrize("seed,half", [(0, 11), (7, 11), (0, 2)])
def test_scene_equals_the_benchmark_generator(seed, half):
    got = _arrays(presets.rtow_final_scene(seed=seed, half=half, device="cpu"))
    want = bench_rtow.scene(seed=seed, half=half)
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_scene_is_the_books_random_scene():
    """484 candidates at half 11, less those within 0.9 of (4, 0.2, 0), plus
    the ground and the three big spheres as published; the materials on
    the port's BSDFs as the configuration states."""
    rng = np.random.default_rng(0)
    kept = 0
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            c = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if math.dist(c, (4.0, 0.2, 0.0)) > 0.9:
                kept += 1
                rng.random(6 if choose < 0.8 else 4 if choose < 0.95 else 0)
    arr = _arrays(presets.rtow_final_scene(device="cpu"))
    n = arr["prim_type"].shape[0]
    assert n == kept + 4 and 480 <= n <= 488
    assert (arr["prim_type"] == 0).all() and (arr["tex_id"] == -1).all()
    assert (arr["reflectivity"] == 0).all() and (arr["emission"] == 0).all()
    small = arr["radius"][1:-3]
    assert (small == np.float32(0.2)).all() and (arr["center"][1:-3, 1] == np.float32(0.2)).all()
    assert arr["radius"][0] == 1000.0 and arr["center"][0].tolist() == [0.0, -1000.0, 0.0]
    assert arr["kd"][0].tolist() == [0.5, 0.5, 0.5] and arr["mat_type"][0] == MaterialType.DIFFUSE
    big = [(arr["center"][i].tolist(), int(arr["mat_type"][i])) for i in range(n - 3, n)]
    assert big == [([0.0, 1.0, 0.0], MaterialType.GLASS), ([-4.0, 1.0, 0.0], MaterialType.DIFFUSE),
                   ([4.0, 1.0, 0.0], MaterialType.METAL)]
    assert arr["kd"][n - 2].tolist() == pytest.approx([0.4, 0.2, 0.1])
    assert arr["smoothness"][n - 1] == 1.0  # fuzz 0
    glass = arr["mat_type"] == MaterialType.GLASS
    assert (arr["ior"][glass] == 1.5).all() and (arr["smoothness"][glass] == 1.0).all()
    assert (arr["kd"][glass] == 1.0).all()
    metal = arr["mat_type"] == MaterialType.METAL
    # fuzz in [0, 0.5): exponent 2 / fuzz^2 >= 8, so smoothness >= ln 8 / ln 1000
    assert (arr["smoothness"][metal] >= math.log(8) / math.log(1000) - 1e-6).all()
    assert (arr["smoothness"][metal] <= 1.0).all() and (arr["kd"][metal] >= 0.5).all()
    assert presets.rtow_metal_smoothness(0.1) == pytest.approx(math.log(200) / math.log(1000))


def test_camera_focuses_ten_units_toward_the_origin():
    cam = presets.rtow_final_camera(device="cpu")
    o, at = cam.origin.double(), cam.look_at.double()
    assert (cam.width, cam.height) == (1200, 800)
    assert float((o - at).norm()) == pytest.approx(10.0, abs=1e-4)
    toward = -o / o.norm()
    assert torch.allclose((at - o) / (at - o).norm(), toward, atol=1e-6)
    assert float(cam.view_fov) == 20.0 and float(cam.lens_radius) == pytest.approx(0.05)
    p = presets.PRESETS["rtow_final"]
    assert (p.width, p.height, p.spp, p.max_depth) == (1200, 800, 500, 50)


def _book_sky(d):
    t = 0.5 * (1.0 + d[..., 1:2])
    return (1.0 - t) + t * torch.tensor(presets.RTOW_SKY_TOP, dtype=d.dtype)


def test_baked_sky_is_the_books_gradient_at_texel_centres():
    """Every texel centre of an upward direction, on either side of the x
    axis (the lookup mirrors negative u), reads the book's gradient."""
    h, w = 256, 512
    sky = presets.rtow_sky(h, w)
    assert np.array_equal(sky, bench_rtow.sky(h, w)) and sky.shape == (h, w, 3)
    tex = torch.from_numpy(sky)
    v = (torch.arange(h, dtype=torch.float64) + 0.5) / h
    u = (torch.arange(w // 4, dtype=torch.float64) + 0.5) / w  # atan's range: u in [0, 1/4)
    el = (math.pi * (v - 0.5))[:, None]
    for az in (2 * math.pi * u, math.pi - 2 * math.pi * u):  # dx > 0, then dx < 0
        az = az[None, :]
        d = torch.stack(torch.broadcast_tensors(torch.cos(el) * torch.cos(az),
                                                torch.cos(el) * torch.sin(az), torch.sin(el)), -1)
        got = texture.sample_sky(tex, d.float())
        assert (d[..., 1] >= 0).all()
        assert torch.allclose(got.double(), _book_sky(d), atol=2e-6, rtol=0)


def test_cli_takes_the_presets_own_sky_unless_sky_is_given(tmp_path):
    from cpppathtracer_tpu_torch.utils.png import write_png

    args = argparse.Namespace(preset="rtow_final", device="cpu", sky=None, size="24x16")
    preset, scene, camera, sky = cli._scene_camera(args)
    assert preset.name == "rtow_final" and (camera.width, camera.height) == (24, 16)
    assert np.array_equal(sky.numpy(), presets.rtow_sky())
    img = np.zeros((4, 8, 3), np.uint8)
    img[..., 1] = 200
    path = tmp_path / "sky.png"
    write_png(str(path), img)
    _, _, _, sky = cli._scene_camera(argparse.Namespace(**{**vars(args), "sky": str(path)}))
    assert np.array_equal(sky.numpy(), texture.load_texture(str(path)))
    # a preset without a sky of its own keeps the command's default sky
    args = argparse.Namespace(preset="cornell", device="cpu", sky=None, size=None)
    assert presets.PRESETS["cornell"].sky_fn is None
    assert torch.equal(cli._scene_camera(args)[3], cli._load_sky(None, torch.device("cpu")))


def _small_render_inputs(w=32, h=24):
    arr = bench_rtow.scene(seed=0, half=2)
    scene = presets.rtow_final_scene(seed=0, half=2, device="cpu")
    camera = presets.rtow_final_camera(w, h, device="cpu")
    sky = torch.from_numpy(presets.rtow_sky())
    ref_cam = tracer.Camera(presets.RTOW_ORIGIN, presets.RTOW_LOOK_AT, 20.0, w, h, "cpu",
                            torch.float32, lens_radius=0.05)
    return arr, scene, camera, sky, ref_cam


def _reference_pixels(arr, ref_cam, sky, pix, dtype, spp, depth):
    scene = tracer.Scene(arr, "cpu", dtype, "expanded")
    cam = tracer.Camera(presets.RTOW_ORIGIN, presets.RTOW_LOOK_AT, 20.0, ref_cam.width,
                        ref_cam.height, "cpu", dtype, lens_radius=0.05)
    rad, _ = tracer.render_pixels(scene, cam, sky.to(dtype), pix, SEED & 0xFFFFFFFF, spp, depth)
    return rad


@pytest.fixture(scope="module")
def small_render():
    """The port's render at half 2, 32x24, 2 spp, depth 50 (the megakernel
    route's plain version on the CPU), and the float32 reference's."""
    arr, scene, camera, sky, ref_cam = _small_render_inputs()
    with torch.no_grad():
        rad, _, _ = integrator.render_radiance(scene, camera, sky, spp=2, max_depth=50,
                                               seed=SEED & 0xFFFFFFFF)
    pix = torch.arange(32 * 24, dtype=torch.int32)
    want = _reference_pixels(arr, ref_cam, sky, pix, torch.float32, 2, 50)
    return rad, want, (arr, scene, camera, sky, ref_cam, pix)


def test_render_agrees_with_the_reference(small_render):
    rad, want, _ = small_render
    assert judge.mismatch_share(rad, want, PIXEL_TOLERANCE) == 0.0
    assert judge.rel_l1(rad, want) < 1e-6


def test_the_reference_in_bfloat16_fails_the_comparison(small_render):
    _, want, (arr, _, _, sky, ref_cam, pix) = small_render
    control = _reference_pixels(arr, ref_cam, sky, pix, torch.bfloat16, 2, 50)
    assert judge.mismatch_share(control, want, PIXEL_TOLERANCE) > 0.5
    assert judge.rel_l1(control, want) > 0.05


def test_winners_equal_the_references_and_paths_outlive_bounce_8(small_render):
    """At every bounce of every path the port's hit (the grouped index, -1
    on a miss) is the reference's; some path still hits past bounce 8, so
    depth 50 is exercised.  A search that finds nothing is a miss, also
    where the ray leaves the ground sphere (grouped index 0) and a
    recompute of that sphere alone would pass."""
    _, _, (arr, scene, camera, sky, ref_cam, pix) = small_render
    gs = fast.group_scene(scene)
    assert gs.counts[0] == len(arr["prim_type"]) and list(scene.type_perm) == list(
        range(len(arr["prim_type"])))
    rscene = tracer.Scene(arr, "cpu", torch.float32, "expanded")
    deepest = 0
    for s in range(2):
        samp = torch.full_like(pix, s)
        with torch.no_grad():
            hits = torch.stack(mega_sample(gs, camera, pix, samp, SEED & 0xFFFFFFFF, 50)[6])
        rec = tracer.trace(rscene, ref_cam, sky, pix, samp, SEED & 0xFFFFFFFF, 50, record=True)
        assert torch.equal(hits, rec.objs)
        assert (hits[1:][hits[:-1] < 0] < 0).all()  # a path ends at its first miss
        deepest = max(deepest, int((hits >= 0).sum(0).max()))
    assert deepest > 9


def test_split_sample_past_depth_24_expands_in_parts(monkeypatch):
    """Past depth 24 phase B's planes (10 + one hit plane a bounce) exceed
    what one expansion takes (MAX_PLANES, the kernel's limit): they go back
    to their lanes in calls of at most that many, and the split sample
    equals the unsplit one (hit planes bitwise, radiance to its sum's
    order)."""
    from cpppathtracer_tpu_torch.ops import mega
    from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import MAX_PLANES

    real, calls = mega.stream_expand, []

    def expand(missed, offs, packed, fills):
        assert 0 < len(packed) <= MAX_PLANES and len(fills) == len(packed)
        calls.append(len(packed))
        return real(missed, offs, packed, fills)

    monkeypatch.setattr(mega, "stream_expand", expand)
    scene = presets.rtow_final_scene(seed=0, half=2, device="cpu")
    gs = fast.group_scene(scene)
    cam = presets.rtow_final_camera(64, 64, device="cpu")
    pix = torch.arange(64 * 64, dtype=torch.int32)

    def sample(split):
        monkeypatch.setenv("POCA_MEGA_SPLIT", split)
        with torch.no_grad():
            return mega_sample(gs, cam, pix, 0, 5, 30)

    split, whole = sample("2"), sample("0")
    assert calls == [MAX_PLANES, 10 + 28 - MAX_PLANES]
    assert torch.equal(torch.stack(split[6]), torch.stack(whole[6]))
    for a, b in zip(split[0], whole[0]):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
