"""The port's lock-step stack BVH (`ops/bvh.py`: `build_bvh_numpy`,
`build_bvh`, `refit_bvh`, `intersect_bvh`, `intersect_auto`) and its
native runtime (`utils/native.py`, built into the port's own `_build/`)
against the JAX package, the port's dense `intersect` and the scalar
oracle: twins of the first five tests of tests/test_bvh.py and of
tests/test_native.py.

Builds are compared array for array (the same median split); hits
against the dense search at tests/test_bvh.py's bounds, and against the
JAX package's walk with winners equal and t at float32 rounding.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu import reference_cpu as ref
from cpppathtracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops import bvh as j_bvh
from cpppathtracer_tpu.types import Rays as JRays
from cpppathtracer_tpu.utils import native as j_native
from cpppathtracer_tpu_torch.ops import bvh
from cpppathtracer_tpu_torch.ops.intersect import intersect
from cpppathtracer_tpu_torch.types import Rays
from cpppathtracer_tpu_torch.utils import native
from cpppathtracer_tpu_torch.utils.png import read_image, write_png

from torch_port_helpers import port_scene

torch.set_num_threads(1)

ARRAYS = ("left", "right", "obj_idx", "aabb_min", "aabb_max")


def _scene(n=40, seed=0):
    rng = np.random.RandomState(seed)
    b = JSceneBuilder()
    b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    for _ in range(n):
        c = rng.uniform(-60, 60, 3)
        c[1] = rng.uniform(1, 20)
        if rng.rand() < 0.7:
            b.add_sphere(c, rng.uniform(1, 5))
        else:
            h = rng.uniform(2, 10)
            c[1] = h / 2
            b.add_cylinder(c, rng.uniform(1, 4), h)
    return b.build()


def _rays(n, seed=1):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-80, 80, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 40, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _same_bvh(got, want):
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.depth == want.depth


def _walk_vs_dense(scene, tree, o, d, winners=True):
    """intersect_bvh against the dense intersect: hits equal and t within
    1e-6; with `winners` also the winners and normals where hit
    (tests/test_bvh.py).  Returns both Hits."""
    rays = Rays.make(o, d, device="cpu")
    dense, via = intersect(scene, rays), bvh.intersect_bvh(scene, tree, rays)
    m = dense.hit.numpy()
    np.testing.assert_array_equal(via.hit.numpy(), m)
    np.testing.assert_allclose(via.t.numpy()[m], dense.t.numpy()[m], rtol=1e-6, atol=1e-6)
    if winners:
        np.testing.assert_array_equal(via.obj_idx.numpy()[m], dense.obj_idx.numpy()[m])
        np.testing.assert_allclose(via.normal.numpy()[m], dense.normal.numpy()[m], atol=1e-6)
    return via, dense


def test_build_structure():
    """build_bvh_numpy over the port's object AABBs equals the JAX
    package's arrays; one leaf per object; every child box inside its
    parent's.  build_bvh (native or NumPy) gives the same BVH as JAX's."""
    jscene = _scene(25)
    scene = port_scene(jscene)
    amin, amax = bvh.object_aabbs(bvh.scene_to_np(scene))
    jmin, jmax = j_bvh.object_aabbs(ref.scene_to_np(jscene))
    np.testing.assert_array_equal(amin, jmin)
    np.testing.assert_array_equal(amax, jmax)
    arrays = bvh.build_bvh_numpy(amin, amax)
    want = j_bvh.build_bvh_numpy(jmin, jmax)
    for k in ARRAYS:
        np.testing.assert_array_equal(arrays[k], want[k], err_msg=k)
    left, right, obj = arrays["left"], arrays["right"], arrays["obj_idx"]
    assert sorted(int(o) for o in obj if o >= 0) == list(range(26))
    for i in range(len(left)):
        if obj[i] < 0:
            assert left[i] >= 0 and right[i] >= 0
            for ch in (left[i], right[i]):
                assert np.all(arrays["aabb_min"][ch] >= arrays["aabb_min"][i] - 1e-6)
                assert np.all(arrays["aabb_max"][ch] <= arrays["aabb_max"][i] + 1e-6)
    _same_bvh(bvh.build_bvh(scene), j_bvh.build_bvh(jscene))


def test_bvh_matches_dense():
    """40 objects, 512 rays: the walk equals the dense search, and its
    winners equal the JAX package's walk's (t at float32 rounding)."""
    jscene = _scene(40)
    scene = port_scene(jscene)
    o, d = _rays(512)
    via, _ = _walk_vs_dense(scene, bvh.build_bvh(scene), o, d)
    jvia = j_bvh.intersect_bvh(jscene, j_bvh.build_bvh(jscene), JRays.make(o, d))
    np.testing.assert_array_equal(via.obj_idx.numpy(), np.asarray(jvia.obj_idx))
    m = via.hit.numpy()
    np.testing.assert_allclose(via.t.numpy()[m], np.asarray(jvia.t)[m], rtol=2e-6)


def test_bvh_demo_scene():
    """demo_scene(0), 256 rays: hits and t as the dense search's (its
    cylinders stand on the floor, so a bottom cap ties with the platform
    and the winners may differ there, as in tests/test_bvh.py).
    intersect_auto takes the dense search at or below its threshold (192
    objects; the demo scene has 93) or without a BVH, the walk above it."""
    scene = port_scene(j_demo_scene(seed=0).build())
    tree = bvh.build_bvh(scene)
    o, d = _rays(256, seed=5)
    via, dense = _walk_vs_dense(scene, tree, o, d, winners=False)
    assert not torch.equal(via.obj_idx, dense.obj_idx)
    rays = Rays.make(o, d, device="cpu")
    assert scene.num_objects <= 192
    for hit, threshold in ((dense, 192), (via, 16)):
        auto = bvh.intersect_auto(scene, rays, tree, dense_threshold=threshold)
        assert torch.equal(auto.obj_idx, hit.obj_idx)
    assert torch.equal(bvh.intersect_auto(scene, rays, dense_threshold=16).obj_idx, dense.obj_idx)


def test_refit_after_move():
    """An object moved: refit_bvh's boxes equal the JAX package's refit,
    and the walk over the refit BVH equals the dense search of the moved
    scene."""
    jscene = _scene(20)
    scene = port_scene(jscene)
    tree, jtree = bvh.build_bvh(scene), j_bvh.build_bvh(jscene)
    center = scene.center.clone()
    center[3] += torch.tensor([5.0, 2.0, -4.0])
    moved = dataclasses.replace(scene, center=center)
    refit = bvh.refit_bvh(tree, moved)
    jrefit = j_bvh.refit_bvh(jtree, dataclasses.replace(jscene, center=jnp.asarray(center.numpy())))
    _same_bvh(refit, jrefit)
    assert not torch.equal(refit.aabb_min, tree.aabb_min)
    _walk_vs_dense(moved, refit, *_rays(256, seed=2))


def test_bvh_traversal_is_differentiable_through_recompute():
    """Rays aimed at ten objects: the gradient of sum(t) over hits with
    respect to the radii is finite, nonzero and equals jax.grad of the JAX
    package's walk at float32 rounding."""
    jscene = _scene(10)
    scene = port_scene(jscene)
    tree, jtree = bvh.build_bvh(scene), j_bvh.build_bvh(jscene)
    centers = np.asarray(jscene.center)[1:11]
    eye = np.array([0.0, 30.0, -200.0], np.float32)
    d = centers - eye
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.tile(eye, (10, 1))
    radius = scene.radius.clone().requires_grad_()
    hit = bvh.intersect_bvh(dataclasses.replace(scene, radius=radius), tree,
                            Rays.make(o, d, device="cpu"))
    (g,) = torch.autograd.grad(torch.where(hit.hit, hit.t, torch.zeros_like(hit.t)).sum(), radius)
    assert torch.isfinite(g).all() and g.abs().sum() > 0

    def f(r):
        h = j_bvh.intersect_bvh(dataclasses.replace(jscene, radius=r), jtree, JRays.make(o, d))
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(f)(jscene.radius)),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ native


@pytest.fixture(scope="module")
def native_lib():
    """The port's own build of native/poca_native.cpp (in its _build/);
    skipped, as tests/test_native.py is, where no toolchain builds it."""
    if not native.available():
        pytest.skip("native toolchain unavailable")
    assert native.SOURCE.parent.name == "native"
    assert native.BUILD_ROOT.parts[-3:] == ("cpppathtracer_tpu_torch", "_build", "native")


def test_native_bvh_build_matches_numpy(native_lib):
    scene = port_scene(j_demo_scene(seed=0).build())
    amin, amax = bvh.object_aabbs(bvh.scene_to_np(scene))
    want = bvh.build_bvh_numpy(amin, amax)
    got = native.build_bvh(amin, amax)
    for k in ARRAYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_bvh_build_matches_numpy_random(native_lib):
    rng = np.random.RandomState(4)
    c = rng.uniform(-100, 100, (257, 3)).astype(np.float32)
    r = rng.uniform(0.5, 5, (257, 1)).astype(np.float32)
    want = bvh.build_bvh_numpy(c - r, c + r)
    got = native.build_bvh(c - r, c + r)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_pack_bgra8(native_lib):
    img = np.array([[[1.0, 0.5, 0.25], [0.0, 2.0, -1.0]]], np.float32)
    out = native.pack_bgra8(img)
    assert out.shape == (1, 2, 4)
    assert list(out[0, 0]) == [63, 127, 255, 255]
    assert list(out[0, 1]) == [0, 255, 0, 255]
    if j_native.available():
        np.testing.assert_array_equal(out, j_native.pack_bgra8(img))


def test_native_png_roundtrip(native_lib, tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (17, 23, 3), dtype=np.uint8)
    p = tmp_path / "t.png"
    native.write_png(str(p), img)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), img)


def test_python_png_writer_roundtrip(tmp_path):
    img = np.random.RandomState(1).randint(0, 256, (9, 11, 3), dtype=np.uint8)
    p = tmp_path / "u.png"
    write_png(str(p), img)
    np.testing.assert_array_equal((read_image(str(p)) * 255).round().astype(np.uint8), img)
