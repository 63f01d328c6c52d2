"""The port's forward slice against the JAX package: render_radiance on the
megakernel path, the split invariance, the denoiser and the progressive
frame step; plus the port's import and device rules."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops.denoise import denoise as j_denoise
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu.renderer import AccumulatorState as JAccumulatorState
from cpppathtracer_tpu.renderer import frame_step as j_frame_step
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import SceneBuilder, demo_scene
from cpppathtracer_tpu_torch.ops import mega
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise
from cpppathtracer_tpu_torch.ops.fast import group_scene
from cpppathtracer_tpu_torch.renderer import (
    AccumulatorState,
    ProgressiveRenderer,
    RenderConfig,
    frame_step,
    to_bgra8,
    to_rgb8,
)

from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_mega(monkeypatch):
    """The JAX package's megakernel path (Pallas in interpret mode on the
    CPU), the counterpart of the port's only path."""
    monkeypatch.setenv("POCA_MEGA", "1")


def _both(jscene, jcam, sky, **kw):
    ref = [np.asarray(a) for a in j_render_radiance(jscene, jcam, jnp.asarray(sky), **kw)]
    got = [a.numpy() for a in render_radiance(
        port_scene(jscene), port_camera(jcam), port_sky(sky), **kw)]
    return got, ref


# Why the render comparisons count pixels.  A secondary ray starts on the
# surface it leaves, and whether it re-hits that surface is decided by the
# rounding of its origin: the quadratics' cancellation error exceeds
# BOUNCE_RAY_TMIN = 2e-5 there.  XLA's CPU code contracts a*b+c into FMAs
# and has its own sqrt and transcendentals, PyTorch rounds every
# operation alone, so a few paths per hundred take another turn (see
# tests/test_torch_kernels.py, which holds the bounces in lockstep).
# Those pixels differ by a whole path's radiance; the rest agree at float32
# rounding.  The bounds below sit a little under the measured shares.


def test_render_controlled_scene_matches_jax(jax_mega):
    """16x12, 2 spp, depth 4: at least 95% of the pixels within 5e-5 (the
    JAX package's own mega-vs-bounce-loop tolerance; measured 96.9%), and
    the first-hit buffers of sample 0 on every pixel whose t agrees."""
    jcam = JCamera.make(16, 12, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))
    got, ref = _both(controlled_scene(), jcam, procedural_sky(16, 16), spp=2, max_depth=4, seed=0)
    close = np.isclose(got[0], ref[0], rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=5e-5)


_SCENE_FIELDS = ("prim_type", "center", "radius", "y_pos", "height", "mat_type", "kd",
                 "emission", "smoothness", "reflectivity", "ior", "tex_id")


def test_scene_without_type_metadata_matches_jax(monkeypatch):
    """A hand-made scene without type metadata: the controlled scene padded
    to 8 objects, in reversed order (padding first, types interleaved),
    type_perm and type_counts empty.  As in the JAX package, it has no
    grouped scene and renders through the row-major body with the dense
    intersect: no kernel and no megakernel, whatever POCA_MEGA says.
    16x12, 2 spp, depth 4: at least 96% of the pixels within 5e-5
    (measured 97.9%, where the planar path it took before agreed on
    93.75%: the same body now rounds as JAX's does but for XLA's FMAs),
    first-hit t within 5e-6 relative (measured 2.6e-6) and normals within
    5e-5 (measured 3.5e-5) on every pixel.  with_bvh raises ValueError on
    it, as JAX's Scene.with_bvh does."""
    monkeypatch.setenv("POCA_MEGA", "1")
    monkeypatch.delenv("POCA_PLANAR", raising=False)
    jscene = controlled_scene(pad_to=8)
    strip = lambda sc, flip: dataclasses.replace(
        sc, type_perm=(), type_counts=(), **{k: flip(getattr(sc, k)) for k in _SCENE_FIELDS})
    jbare = strip(jscene, lambda a: a[::-1])
    bare = strip(port_scene(jscene), lambda a: a.flip(0))
    assert group_scene(bare) is None
    jcam = JCamera.make(16, 12, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))
    sky = procedural_sky(16, 16)
    ref = [np.asarray(a) for a in j_render_radiance(jbare, jcam, jnp.asarray(sky), spp=2,
                                                    max_depth=4, seed=0)]
    kb.reset_launches()
    got = [a.numpy() for a in render_radiance(bare, port_camera(jcam), port_sky(sky), spp=2,
                                              max_depth=4, seed=0)]
    assert not any(kb.LAUNCHES.values())
    close = np.isclose(got[0], ref[0], rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.96, close.mean()
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-6)
    np.testing.assert_allclose(got[1], ref[1], atol=5e-5)
    with pytest.raises(ValueError):
        bare.with_bvh()
    with pytest.raises(ValueError):
        jbare.with_bvh()


def test_render_demo_scene_matches_jax(jax_mega):
    """demo_scene(0) with the bench camera, 32x24, 2 spp, depth 4: at
    least 80% of the pixels within 1e-4 (measured 84.4%; the scene's
    coordinates reach 550, where one ulp is 6e-5, three times tmin), and
    the mean radiance within 2%."""
    jcam = JCamera.make(32, 24, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
    got, ref = _both(j_demo_scene(seed=0).build(), jcam, procedural_sky(16, 16),
                     spp=2, max_depth=4, seed=0)
    close = np.isclose(got[0], ref[0], rtol=0, atol=1e-4).all(-1)
    assert close.mean() >= 0.80, close.mean()
    assert abs(got[0].mean() / ref[0].mean() - 1) < 0.02
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-5)


def test_split_path_matches_unsplit(monkeypatch):
    """64x64 x depth 4 takes the split (phase A, compaction, phase B,
    expansion).  Against the same render unsplit: hit planes, first-hit
    normals and t bitwise equal, radiance within 5e-7 (the float32 sum
    runs in another order)."""
    scene = port_scene(controlled_scene())
    cam = port_camera(JCamera.make(64, 64, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0)))
    sky = port_sky(procedural_sky(8, 8))
    assert mega._split_plan(64 * 64, 4) == 2
    gs = group_scene(scene)
    pix = torch.arange(64 * 64, dtype=torch.int32)

    def run():
        sample = mega.mega_sample(gs, cam, pix, 1, 3, 4)
        rad = render_radiance(scene, cam, sky, spp=2, max_depth=4, seed=3, spp_chunk=2)
        return sample, rad

    (s1, r1) = run()
    monkeypatch.setattr(mega, "_split_plan", lambda r, depth: 0)
    (s0, r0) = run()
    assert (s1[3] == 0).float().mean() < 0.9  # some paths survive the split
    for h1, h0 in zip(s1[6], s0[6]):
        assert torch.equal(h1, h0)
    for a, b in zip((*s1[4], s1[5]), (*s0[4], s0[5])):
        assert torch.equal(a, b)
    for k in range(3):
        np.testing.assert_allclose(s1[0][k].numpy(), s0[0][k].numpy(), rtol=5e-7, atol=5e-7)
        assert torch.equal(s1[1][k], s0[1][k]) and torch.equal(s1[2][k], s0[2][k])
    assert torch.equal(s1[3], s0[3])
    np.testing.assert_allclose(r1[0].numpy(), r0[0].numpy(), rtol=5e-7, atol=5e-7)
    assert torch.equal(r1[1], r0[1]) and torch.equal(r1[2], r0[2])


def test_denoise_matches_jax():
    rng = np.random.RandomState(4)
    rad = rng.uniform(0, 2, (24, 32, 3)).astype(np.float32)
    nrm = rng.normal(size=(24, 32, 3)).astype(np.float32)
    dep = rng.uniform(0, 50, (24, 32)).astype(np.float32)
    for step in (1, 2):
        ref = np.asarray(j_denoise(jnp.asarray(rad), jnp.asarray(nrm), jnp.asarray(dep), step))
        got = denoise(torch.from_numpy(rad), torch.from_numpy(nrm), torch.from_numpy(dep), step)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def _floor_and_sphere(cls):
    """The scene of tests/test_renderer.py: a floor and one sphere."""
    b = cls()
    b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.6, 0.3, 0.3))
    return b


def test_frame_step_matches_jax(jax_mega):
    """Three denoised progressive frames at 32x24, depth 3, on the scene of
    tests/test_renderer.py: at least 80% of the pixels within 1e-4 every
    frame (measured 85.9-87.8%: the 5x5 denoiser spreads each diverging
    path over 25 pixels), and the mean within 1%."""
    jscene = _floor_and_sphere(JSceneBuilder).build()
    jcam = JCamera.make(32, 24, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0))
    sky = procedural_sky(16, 16)
    jstate = JAccumulatorState.create(24, 32)
    state = AccumulatorState.create(24, 32, "cpu")
    scene, cam, tsky = port_scene(jscene), port_camera(jcam), port_sky(sky)
    for _ in range(3):
        jstate, jimg = j_frame_step(jscene, jcam, jnp.asarray(sky), jstate, 0, 3, True, 1)
        state, img = frame_step(scene, cam, tsky, state, 0, 3, True, 1)
        close = np.isclose(img.numpy(), np.asarray(jimg), rtol=0, atol=1e-4).all(-1)
        assert close.mean() >= 0.80, close.mean()
        assert abs(img.numpy().mean() / np.asarray(jimg).mean() - 1) < 0.01
    assert state.sample_idx == int(jstate.sample_idx) == 3


def test_progressive_renderer_on_cpu():
    b = _floor_and_sphere(SceneBuilder)
    cam = Camera.make(12, 8, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device="cpu")
    r = ProgressiveRenderer(b.build(device="cpu"), cam, procedural_sky(16, 16),
                            RenderConfig(width=12, height=8, max_depth=3))
    first = r.step().numpy()
    assert first.shape == (8, 12, 3) and 0.0 <= first.min() and first.max() <= 1.0
    r.step()
    assert r.state.sample_idx == 2
    r.move_camera(Camera.move_forward, 0.5)
    assert r.state.sample_idx == 0 and not r.frame().any()
    r.step()
    assert to_bgra8(r.frame()).shape == (8, 12, 4) and to_rgb8(r.frame()).dtype == np.uint8


def test_port_imports_no_jax():
    """Importing the port and rendering with it on the CPU, a dense scene
    on the megakernel path and a BVH scene on the wavefront path, loads
    neither JAX nor the JAX package."""
    code = (
        "import sys, torch\n"
        "from cpppathtracer_tpu_torch.models.scene import demo_scene\n"
        "from cpppathtracer_tpu_torch.models.camera import Camera\n"
        "from cpppathtracer_tpu_torch.ops.texture import procedural_sky\n"
        "from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig\n"
        "import cpppathtracer_tpu_torch.convert\n"
        "s = demo_scene(0).build(device='cpu')\n"
        "c = Camera.make(8, 6, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device='cpu')\n"
        "r = ProgressiveRenderer(s, c, procedural_sky(8, 8), RenderConfig(8, 6, max_depth=2))\n"
        "assert torch.isfinite(r.step()).all()\n"
        "from cpppathtracer_tpu_torch.integrator import render_radiance\n"
        "from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene\n"
        "b = big_scene(96, bvh=True, device='cpu')\n"
        "rad, _, _ = render_radiance(b, big_camera(96, 8, 6, device='cpu'), r.sky_tex, spp=1, max_depth=2)\n"
        "assert b.bvh_meta is not None and torch.isfinite(rad).all()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cpppathtracer_tpu.'))"
        " or m == 'cpppathtracer_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without a card and without device=..., entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_scene(0).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Camera.make(8, 8)
    scene = demo_scene(0).build(device="cpu", bvh=True)
    assert scene.bvh_meta is not None and scene.bvh_dims[0] == scene.bvh_meta.shape[0]
