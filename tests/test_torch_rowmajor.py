"""The port's row-major dense family against the JAX package and the scalar
oracle (reference_cpu): the row-major `mathx`, `intersect.intersect`,
`bsdf.shade` / `gather_materials` (twins of tests/test_mathx.py,
tests/test_intersect.py and tests/test_bsdf.py), `uv.surface_uv`,
`texture.sample_sky`, `fast.intersect_and_gather` with either winner
search, and the row-major body of the integrator: route A (a grouped scene
under POCA_MEGA=0 POCA_PLANAR=0, the winner kernel's path), route B (a
scene without type metadata: dense `intersect` and no kernel) on flat and
2-D pixel batches, the grouped 2-D batch that raises, and a route A
gradient against `jax.grad`.

Tolerances follow ROADMAP.md: winners equal except on float32 near-ties;
attributes and radiance allclose at float32 rounding, renders as a share
of pixels (XLA's CPU code contracts a*b+c into FMAs and PyTorch does not,
so a secondary ray's re-hit at t ~ tmin can flip; see
tests/test_torch_render.py).  Inputs come from numpy seeds.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu import reference_cpu as ref
from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.integrator import render_sample as j_render_sample
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops import bsdf as j_bsdf
from cpppathtracer_tpu.ops import fast as j_fast
from cpppathtracer_tpu.ops import intersect as j_intersect
from cpppathtracer_tpu.ops import mathx as j_mathx
from cpppathtracer_tpu.ops import texture as j_texture
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu.ops.uv import surface_uv as j_surface_uv
from cpppathtracer_tpu.types import MaterialType
from cpppathtracer_tpu.types import Rays as JRays
from cpppathtracer_tpu.utils.rng import uniforms4 as j_uniforms4
from cpppathtracer_tpu_torch import convert
from cpppathtracer_tpu_torch.integrator import render_radiance, render_sample
from cpppathtracer_tpu_torch.ops import bsdf, fast, intersect, mathx, texture
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.uv import surface_uv
from cpppathtracer_tpu_torch.types import Rays
from cpppathtracer_tpu_torch.utils.rng import uniforms4

from test_torch_grad import _agreeing_pixels, _jax_grads, _port_grads
from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

RNG = np.random.RandomState(42)
SKY = procedural_sky(16, 16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rand_unit(n, rng=RNG):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _strip(scene, flip):
    """The scene without type metadata, its object order changed by flip."""
    return dataclasses.replace(scene, type_perm=(), type_counts=(),
                               **{k: flip(getattr(scene, k)) for k in convert.SCENE_FIELDS})


# ------------------------------------------------------------------ mathx
# Each twin holds the port against the oracle at tests/test_mathx.py's
# bound and against the JAX function at float32 rounding (2e-6 on unit
# vectors: XLA contracts FMAs, PyTorch does not).


def test_to_world_matches_oracle():
    a, n = _rand_unit(256), _rand_unit(256)
    got = _n(mathx.to_world(_t(a), _t(n)))
    want = np.stack([ref._to_world(a[i], n[i]) for i in range(256)])
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j_mathx.to_world(jnp.asarray(a), jnp.asarray(n))),
                               atol=2e-6)


def test_to_world_preserves_z_alignment():
    n = _rand_unit(128)
    z = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (128, 1))
    np.testing.assert_allclose(_n(mathx.to_world(_t(z), _t(n))), n, atol=1e-5)


def test_to_world_is_orthonormal_rotation():
    a, n = _rand_unit(128), _rand_unit(128)
    got = _n(mathx.to_world(_t(a), _t(n)))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), np.ones(128), atol=1e-4)


def test_schlick_matches_oracle():
    cos = RNG.uniform(0, 1, 64).astype(np.float32)
    ior = RNG.uniform(1.0, 3.0, 64).astype(np.float32)
    got = _n(mathx.schlick(_t(cos), _t(ior)))
    np.testing.assert_allclose(got, [ref._schlick(cos[i], ior[i]) for i in range(64)], atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j_mathx.schlick(jnp.asarray(cos), jnp.asarray(ior))),
                               rtol=1e-6, atol=1e-7)


def test_refract_matches_oracle():
    v, n = _rand_unit(256), _rand_unit(256)
    n = np.where((np.sum(v * n, -1) > 0)[:, None], -n, n).astype(np.float32)
    eta = RNG.uniform(0.4, 2.5, 256).astype(np.float32)
    got_d, got_ok = (_n(x) for x in mathx.refract(_t(v), _t(n), _t(eta)))
    jd, jok = (np.asarray(x) for x in j_mathx.refract(jnp.asarray(v), jnp.asarray(n),
                                                       jnp.asarray(eta)))
    np.testing.assert_array_equal(got_ok, jok)
    np.testing.assert_allclose(got_d, jd, atol=2e-6)
    for i in range(256):
        want_d, want_ok = ref._refract(v[i], n[i], eta[i])
        assert got_ok[i] == want_ok, i
        if want_ok:
            np.testing.assert_allclose(got_d[i], want_d, atol=1e-5)


def test_reflect():
    v, n = _rand_unit(64), _rand_unit(64)
    got = _n(mathx.reflect(_t(v), _t(n)))
    np.testing.assert_allclose(got, v - 2 * np.sum(v * n, -1, keepdims=True) * n, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j_mathx.reflect(jnp.asarray(v), jnp.asarray(n))),
                               atol=2e-6)


def test_phong_lobe_cosine_distribution():
    """alpha = 2 is the cosine-weighted hemisphere, E[z] = 2/3; on the
    same (bitwise equal) uniforms the lobe equals the JAX package's."""
    pix = np.arange(1 << 14, dtype=np.int32)
    u1, u2, _, _ = uniforms4(0, _t(pix), 0, 0)
    local = _n(mathx.phong_lobe_local(u1, u2, torch.full_like(u1, 2.0)))
    assert abs(local[:, 2].mean() - 2.0 / 3.0) < 0.01
    np.testing.assert_allclose(np.linalg.norm(local, axis=-1), 1.0, atol=1e-4)
    ju1, ju2, _, _ = j_uniforms4(0, jnp.asarray(pix), 0, 0)
    want = np.asarray(j_mathx.phong_lobe_local(ju1, ju2, jnp.float32(2.0)))
    np.testing.assert_allclose(local, want, atol=2e-6)


def test_vector_helpers_match_jax():
    """dot, cross, length and normalize (zero vectors included) against
    the JAX package's, which reduce with jnp.sum / jnp.cross."""
    a, b = RNG.normal(size=(2, 300, 3)).astype(np.float32)
    a[:5] = 0.0
    for name in ("dot", "cross"):
        np.testing.assert_allclose(_n(getattr(mathx, name)(_t(a), _t(b))),
                                   np.asarray(getattr(j_mathx, name)(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("length", "normalize"):
        np.testing.assert_allclose(_n(getattr(mathx, name)(_t(a))),
                                   np.asarray(getattr(j_mathx, name)(jnp.asarray(a))),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert not _n(mathx.normalize(_t(a[:5]))).any()


# -------------------------------------------------------------- intersect


def _random_scene(seed=0, n_sph=6, n_cyl=4, platform=True, neg_shell=True):
    rng = np.random.RandomState(seed)
    b = JSceneBuilder()
    if platform:
        b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    for _ in range(n_sph):
        c = rng.uniform(-20, 20, 3)
        c[1] = rng.uniform(1, 15)
        b.add_sphere(c, rng.uniform(1, 6), kd=tuple(rng.uniform(0, 1, 3)))
    if neg_shell:
        c = rng.uniform(-10, 10, 3)
        c[1] = 5.0
        b.add_sphere(c, 4.0, mat_type=MaterialType.GLASS)
        b.add_sphere(c, 0.01 - 4.0, mat_type=MaterialType.GLASS)
    for _ in range(n_cyl):
        c = rng.uniform(-20, 20, 3)
        h = rng.uniform(2, 10)
        c[1] = h / 2
        b.add_cylinder(c, rng.uniform(1, 5), h, kd=tuple(rng.uniform(0, 1, 3)))
    return b.build()


def _random_rays(n, seed=1):
    rng = np.random.RandomState(seed)
    origin = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    origin[:, 1] = rng.uniform(0.5, 30, n)
    return origin, _rand_unit(n, rng)


def _intersect_port(jscene, origin, direction, tmin=0.0):
    """The port's closest hits; the hit flags and winners equal the JAX
    package's, t within 1e-5 relative where hit."""
    tmin = np.full(origin.shape[0], tmin, np.float32)
    got = intersect.intersect(port_scene(jscene), Rays.make(origin, direction, tmin, device="cpu"))
    want = j_intersect.intersect(jscene, JRays.make(origin, direction, tmin=tmin))
    np.testing.assert_array_equal(_n(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(_n(got.obj_idx), np.asarray(want.obj_idx))
    m = _n(got.hit)
    np.testing.assert_allclose(_n(got.t)[m], np.asarray(want.t)[m], rtol=1e-5)
    return got


def _compare(jscene, origin, direction, tmin=0.0):
    """The port's closest hits against the JAX package's (hit flags equal;
    winners equal except where two objects' t agree within 1e-5
    relative; t within 1e-5 relative and normals within 1e-5 where they
    agree) and against the oracle at tests/test_intersect.py's bounds."""
    tmins = np.full(origin.shape[0], tmin, np.float32)
    got = intersect.intersect(port_scene(jscene), Rays.make(origin, direction, tmins, device="cpu"))
    want = j_intersect.intersect(jscene, JRays.make(origin, direction, tmin=tmins))
    g_hit, g_t, g_n, g_obj = (_n(getattr(got, k)) for k in ("hit", "t", "normal", "obj_idx"))
    np.testing.assert_array_equal(g_hit, np.asarray(want.hit))
    same = g_obj == np.asarray(want.obj_idx)
    np.testing.assert_allclose(g_t[~same], np.asarray(want.t)[~same], rtol=1e-5)
    np.testing.assert_allclose(g_t[same & g_hit], np.asarray(want.t)[same & g_hit], rtol=1e-5)
    np.testing.assert_allclose(g_n[same & g_hit], np.asarray(want.normal)[same & g_hit], atol=1e-5)
    assert (~same).sum() <= 2, (~same).sum()
    sc = ref.scene_to_np(jscene)
    n_mismatch = 0
    for i in range(origin.shape[0]):
        res = ref.intersect_scene_np(sc, origin[i], direction[i], np.float32(tmin), np.float32(1e30))
        if res is None:
            assert not g_hit[i], f"ray {i}: port hit, oracle miss"
            continue
        t, normal, obj = res
        assert g_hit[i], f"ray {i}: port miss, oracle hit t={t}"
        if int(g_obj[i]) != obj:
            assert abs(float(g_t[i]) - t) < 1e-3 * max(1.0, abs(t))
            n_mismatch += 1
            continue
        np.testing.assert_allclose(float(g_t[i]), t, rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(g_n[i], normal, rtol=1e-4, atol=1e-4)
    assert n_mismatch <= origin.shape[0] // 50


def test_sphere_platform_cylinder_scene():
    _compare(_random_scene(0), *_random_rays(512))


def test_bounce_tmin_window():
    _compare(_random_scene(3), *_random_rays(256, seed=9), tmin=2e-5)


def _one_object(add, *args):
    b = JSceneBuilder()
    getattr(b, add)(*args)
    return b.build()


def test_negative_radius_sphere_normal_inverted():
    got = _intersect_port(_one_object("add_sphere", (0.0, 0.0, 0.0), -2.0),
                          np.array([[0.0, 0.0, -10.0]], np.float32),
                          np.array([[0.0, 0.0, 1.0]], np.float32))
    assert bool(got.hit[0])
    np.testing.assert_allclose(float(got.t[0]), 8.0, atol=1e-4)
    np.testing.assert_allclose(_n(got.normal[0]), [0, 0, 1], atol=1e-5)


def test_sphere_inside_far_root():
    got = _intersect_port(_one_object("add_sphere", (0.0, 0.0, 0.0), 2.0),
                          np.zeros((1, 3), np.float32), np.array([[0.0, 0.0, 1.0]], np.float32))
    assert bool(got.hit[0])
    np.testing.assert_allclose(float(got.t[0]), 2.0, atol=1e-5)
    np.testing.assert_allclose(_n(got.normal[0]), [0, 0, 1], atol=1e-5)


def test_platform_normal_faces_ray():
    got = _intersect_port(_one_object("add_platform", 0.0),
                          np.array([[0.0, 5.0, 0.0], [0.0, -5.0, 0.0]], np.float32),
                          np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]], np.float32))
    assert bool(got.hit.all())
    np.testing.assert_allclose(_n(got.normal), [[0, 1, 0], [0, -1, 0]], atol=1e-6)


def test_cylinder_cap_and_lateral():
    got = _intersect_port(_one_object("add_cylinder", (0.0, 2.0, 0.0), 1.0, 4.0),
                          np.array([[0.0, 10.0, 0.0], [-5.0, 2.0, 0.0]], np.float32),
                          np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0]], np.float32))
    np.testing.assert_allclose(_n(got.t), [6.0, 4.0], atol=1e-5)
    np.testing.assert_allclose(_n(got.normal), [[0, 1, 0], [-1, 0, 0]], atol=1e-5)


def test_miss_everything():
    got = _intersect_port(_one_object("add_sphere", (0.0, 0.0, 0.0), 1.0),
                          np.array([[0.0, 5.0, 0.0]], np.float32),
                          np.array([[0.0, 1.0, 0.0]], np.float32))
    assert not bool(got.hit[0]) and int(got.obj_idx[0]) == -1
    assert float(got.t[0]) == float(np.float32(1e30))


# ------------------------------------------------------------------- bsdf


def _scene_one_of_each():
    b = JSceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, mat_type=MaterialType.DIFFUSE, kd=(0.8, 0.4, 0.2), emission=0.5)
    b.add_sphere((0, 0, 0), 1.0, mat_type=MaterialType.METAL, kd=(0.9, 0.9, 0.1), smoothness=2.5)
    b.add_sphere((0, 0, 0), 1.0, mat_type=MaterialType.MIRROR, kd=(0.7, 0.7, 0.9),
                 smoothness=1.5, reflectivity=0.6)
    b.add_sphere((0, 0, 0), 1.0, mat_type=MaterialType.GLASS, kd=(1.0, 1.0, 1.0),
                 smoothness=3.0, ior=1.5)
    return b.build()


def _shade_both(jscene, obj, normal, in_dir, u):
    n_rays = normal.shape[0]
    mats = bsdf.gather_materials(port_scene(jscene), torch.full((n_rays,), obj, dtype=torch.int32))
    got = [_n(x) for x in bsdf.shade(mats, _t(normal), _t(in_dir), *(_t(x) for x in u))]
    jm = j_bsdf.gather_materials(jscene, jnp.full(n_rays, obj, jnp.int32))
    want = [np.asarray(x) for x in j_bsdf.shade(jm, jnp.asarray(normal), jnp.asarray(in_dir),
                                                 *(jnp.asarray(x) for x in u))]
    return got, want


def test_shade_matches_oracle_all_materials():
    """Per material, the port's shade against the JAX package's (the
    bounce direction within 2e-5: the Phong lobe's exp and pow differ in
    the last bits between XLA and PyTorch, and to_world carries them) and
    against the oracle at tests/test_bsdf.py's bounds."""
    jscene = _scene_one_of_each()
    sc = ref.scene_to_np(jscene)
    n_rays = 64
    for obj in range(4):
        normal, in_dir = _rand_unit(n_rays), _rand_unit(n_rays)
        u = [RNG.uniform(0, 1, n_rays).astype(np.float32) for _ in range(3)]
        (wo, att, emit), want = _shade_both(jscene, obj, normal, in_dir, u)
        np.testing.assert_allclose(wo, want[0], atol=2e-5, err_msg=f"obj {obj} dir")
        np.testing.assert_allclose(att, want[1], atol=1e-6, err_msg=f"obj {obj} att")
        np.testing.assert_array_equal(emit, want[2], err_msg=f"obj {obj} emit")
        for i in range(n_rays):
            wwo, watt, wemit = ref._shade(sc, obj, normal[i], in_dir[i], u[0][i], u[1][i], u[2][i])
            np.testing.assert_allclose(wo[i], wwo, atol=2e-4, err_msg=f"obj {obj} ray {i} dir")
            np.testing.assert_allclose(att[i], watt, atol=1e-5, err_msg=f"obj {obj} ray {i} att")
            np.testing.assert_allclose(emit[i], wemit, atol=1e-6, err_msg=f"obj {obj} ray {i} emit")


def test_diffuse_cosine_sampling_stats():
    n = 1 << 14
    normal = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    in_dir = np.tile(np.array([[0.0, 0.7071, -0.7071]], np.float32), (n, 1))
    u = [_n(x) for x in uniforms4(0, torch.arange(n), 0, 1)[:3]]
    (wo, _, _), want = _shade_both(_scene_one_of_each(), 0, normal, in_dir, u)
    cos_t = wo[:, 2] / np.linalg.norm(wo, axis=-1)
    assert abs(cos_t.mean() - 2 / 3) < 0.01 and (cos_t > 0).all()
    np.testing.assert_allclose(wo, want[0], atol=2e-6)


def test_glass_energy_not_attenuated_below_horizon():
    n = 256
    u = [RNG.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    (_, att, _), want = _shade_both(_scene_one_of_each(), 3, _rand_unit(n), _rand_unit(n), u)
    np.testing.assert_allclose(att, 1.0, atol=1e-6)
    np.testing.assert_allclose(att, want[1], atol=1e-6)


def test_mirror_reflectivity_mix():
    b = JSceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, mat_type=MaterialType.MIRROR, kd=(0.5, 0.5, 0.5),
                 smoothness=2.0, reflectivity=0.0)
    n = 4096
    normal = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    in_dir = np.tile(np.array([[0.7071, 0.0, -0.7071]], np.float32), (n, 1))
    u = [_n(x) for x in uniforms4(1, torch.arange(n), 0, 1)[:3]]
    (wo, _, _), want = _shade_both(b.build(), 0, normal, in_dir, u)
    assert abs(wo[:, 2].mean() - 2 / 3) < 0.02
    np.testing.assert_allclose(wo, want[0], atol=2e-6)


def test_unknown_mat_type_dispatches_to_diffuse():
    """TEST and any unknown type run the diffuse shader bitwise, and so
    does the oracle (at tests/test_bsdf.py's bounds)."""
    b = JSceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, mat_type=MaterialType.DIFFUSE, kd=(0.8, 0.4, 0.2), emission=0.3)
    jscene = b.build()
    scene = port_scene(jscene)
    n = 64
    normal, in_dir = _t(_rand_unit(n)), _t(_rand_unit(n))
    u = [_t(RNG.uniform(0, 1, n).astype(np.float32)) for _ in range(3)]
    mats = bsdf.gather_materials(scene, torch.zeros(n, dtype=torch.int32))
    want = bsdf.shade(mats, normal, in_dir, *u)
    for unknown in (MaterialType.TEST, 7):
        got = bsdf.shade(dict(mats, mat_type=torch.full((n,), int(unknown), dtype=torch.int32)),
                         normal, in_dir, *u)
        assert all(torch.equal(a, b_) for a, b_ in zip(want, got))
        sc = ref.scene_to_np(jscene)
        sc["mat_type"] = np.full(1, int(unknown), np.int32)
        for i in range(8):
            wwo, watt, _ = ref._shade(sc, 0, *(_n(x[i]) for x in (normal, in_dir, *u)))
            np.testing.assert_allclose(_n(got[0][i]), wwo, atol=2e-4)
            np.testing.assert_allclose(_n(got[1][i]), watt, atol=1e-5)


# --------------------------------------------------- uv, sky, fast entry


def test_surface_uv_and_sample_sky_match_jax():
    """The row-major hit UVs of every primitive type and the four-tap sky
    fetch, against the JAX package's at float32 rounding."""
    n = 300
    rng = np.random.RandomState(3)
    prim = rng.randint(0, 3, n).astype(np.int32)
    center = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    radius = rng.uniform(0.5, 3, n).astype(np.float32)
    y_pos = rng.uniform(-1, 1, n).astype(np.float32)
    height = rng.uniform(1, 4, n).astype(np.float32)
    pos = center + _rand_unit(n, rng) * radius[:, None]
    args = (prim, center, radius, y_pos, height, pos)
    got = [_n(x) for x in surface_uv(*(_t(a) for a in args))]
    want = [np.asarray(x) for x in j_surface_uv(*(jnp.asarray(a) for a in args))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    d = _rand_unit(n, rng)
    np.testing.assert_allclose(_n(texture.sample_sky(_t(SKY), _t(d))),
                               np.asarray(j_texture.sample_sky(jnp.asarray(SKY), jnp.asarray(d))),
                               atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_intersect_and_gather_matches_jax(use_pallas):
    """fast.intersect_and_gather on demo_scene(0) and 512 random rays
    (winner_index's plain version on these CPU tensors) against JAX's
    with use_pallas False (its XLA `_winner_grouped_T`) and True (its
    Pallas kernel in interpret mode).  Winners equal except where the two
    closest objects' t agree within 1e-5 relative (none in these rays),
    records equal, hit attributes at float32 rounding; the port's
    `_winner_grouped_T` equals JAX's in index, and in its search t within
    5e-5 relative (the expanded quadratic cancels where a ray passes far
    from a sphere's centre; measured 1.9e-5 on 7 of 512 lanes, where the
    recomputed hit t above agrees within 1e-6); the row-major winner
    equals the planar path's."""
    jscene = j_demo_scene(seed=0).build()
    rng = np.random.RandomState(21)
    o = rng.uniform(-100, 100, (512, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 60, 512)
    d = _rand_unit(512, rng)
    gs = fast.group_scene(port_scene(jscene))
    jgs = j_fast.group_scene(jscene)
    rays = Rays.make(o, d, device="cpu")
    hit, mats = fast.intersect_and_gather(gs, rays)
    jhit, jmats = j_fast.intersect_and_gather(jgs, JRays.make(o, d), use_pallas=use_pallas)
    np.testing.assert_array_equal(_n(hit.hit), np.asarray(jhit.hit))
    np.testing.assert_array_equal(_n(hit.obj_idx), np.asarray(jhit.obj_idx))
    m = _n(hit.hit)
    assert m.mean() > 0.25
    np.testing.assert_allclose(_n(hit.t)[m], np.asarray(jhit.t)[m], rtol=1e-6)
    np.testing.assert_allclose(_n(hit.pos)[m], np.asarray(jhit.pos)[m], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_n(hit.normal)[m], np.asarray(jhit.normal)[m], atol=2e-6)
    for k in ("mat_type", "kd", "emission", "smoothness", "reflectivity", "ior", "tex_id"):
        np.testing.assert_array_equal(_n(mats[k]), np.asarray(jmats[k]), err_msg=k)
    t_g, i_g = fast._winner_grouped_T(gs, rays)
    jt_g, ji_g = j_fast._winner_grouped_T(jgs, JRays.make(o, d))
    np.testing.assert_array_equal(_n(i_g), np.asarray(ji_g))
    np.testing.assert_allclose(_n(t_g), np.asarray(jt_g), rtol=5e-5)
    planar_hit, _ = fast.intersect_and_gather_planar(
        gs, tuple(rays.origin.unbind(-1)), tuple(rays.dir.unbind(-1)), rays.tmin, rays.tmax)
    assert torch.equal(planar_hit["obj_idx"], hit.obj_idx)


# ---------------------------------------------------------------- renders


@pytest.fixture
def route_a(monkeypatch):
    """A grouped scene on the row-major body, in both packages."""
    monkeypatch.setenv("POCA_MEGA", "0")
    monkeypatch.setenv("POCA_PLANAR", "0")
    monkeypatch.delenv("POCA_PALLAS", raising=False)
    return monkeypatch


def _jcam():
    return JCamera.make(16, 12, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))


def test_route_a_render_matches_jax(route_a):
    """The controlled scene on the row-major body, 16x12, 2 spp, depth 4:
    at least 96% of the pixels within 5e-5 (measured 97.9%), first-hit t
    within 5e-6 relative and normals within 5e-5 on every pixel.  No
    kernel is launched on the CPU."""
    jscene = controlled_scene()
    ref_out = [np.asarray(a) for a in j_render_radiance(jscene, _jcam(), jnp.asarray(SKY), spp=2,
                                                        max_depth=4, seed=0)]
    scene, cam, sky = port_scene(jscene), port_camera(_jcam()), port_sky(SKY)
    kb.reset_launches()
    got = render_radiance(scene, cam, sky, spp=2, max_depth=4, seed=0)
    assert not any(kb.LAUNCHES.values())
    close = np.isclose(_n(got[0]), ref_out[0], rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.96, close.mean()
    np.testing.assert_allclose(_n(got[2]), ref_out[2], rtol=5e-6)
    np.testing.assert_allclose(_n(got[1]), ref_out[1], atol=5e-5)


def test_route_a_bvh_sized_scene_renders(route_a):
    """big_scene(8192) (8,208 geometry rows, past the 7,264 one block of
    the card stages, so the dense search takes two tiles; the scene
    carries BVH tables, which route A does not use, as in JAX) on the
    row-major body, 16x12 pixels, 1 spp, depth 2, against the JAX
    package's POCA_PLANAR=0 render.  The primary winners equal JAX's
    `_winner_grouped_T`; first-hit t within 5e-6 relative and normals
    within 5e-5 on every pixel, as test_route_a_render_matches_jax holds
    them.  Radiance: at least 90% of the pixels within 5e-5 (measured
    94.3%).  The others are paths whose bounce-1 ray re-hits the surface
    it leaves in one package and not in the other: the first-hit t
    differs by up to 5e-6 relative (XLA's CPU code contracts FMAs), which
    at t ~ 60 moves the secondary origin by more than BOUNCE_RAY_TMIN,
    the divergence ROADMAP.md records for the demo scene.  The camera
    looks at the middle of the grid from 50 units; from big_camera's
    corner, 1,100 units out, 81% of 8x6 pixels agree, for the same
    reason."""
    from cpppathtracer_tpu.models.presets import big_scene as j_big_scene
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import WINNER_TILE_ROWS, build_geom_rows

    jscene = j_big_scene(8192)
    jcam = JCamera.make(16, 12, origin=(3.0, 30.0, -40.0), look_at=(0.0, 0.0, 0.0))
    scene, cam = port_scene(jscene), port_camera(jcam)
    assert scene.bvh_meta is not None
    gs = fast.group_scene(scene)
    assert build_geom_rows(gs).shape[0] > WINNER_TILE_ROWS
    pix = torch.arange(16 * 12, dtype=torch.int32)
    rays = cam.ray_gen(pix, 0, 0)
    jrays = JRays.make(_n(rays.origin), _n(rays.dir))
    np.testing.assert_array_equal(_n(fast.winner_index_rowmajor(gs, rays)),
                                  np.asarray(j_fast._winner_grouped_T(j_fast.group_scene(jscene),
                                                                      jrays)[1]))
    ref_out = [np.asarray(a) for a in j_render_radiance(jscene, jcam, jnp.asarray(SKY), spp=1,
                                                        max_depth=2, seed=0)]
    kb.reset_launches()
    got = render_radiance(scene, cam, port_sky(SKY), spp=1, max_depth=2, seed=0)
    assert not any(kb.LAUNCHES.values())
    assert np.isfinite(_n(got[0])).all()
    close = np.isclose(_n(got[0]), ref_out[0], rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.90, close.mean()
    np.testing.assert_allclose(_n(got[2]), ref_out[2], rtol=5e-6)
    np.testing.assert_allclose(_n(got[1]), ref_out[1], atol=5e-5)


@pytest.mark.parametrize("tile_rows", [8, 16, 24])
def test_winner_search_over_tiles_equals_one_tile(tile_rows):
    """winner_t_index_plain over tiles of `tile_rows` geometry rows (tiles
    that start and end inside each type group) equals the search over one
    tile bitwise, index and t, on a random scene of 37 spheres, a platform
    and 29 cylinders (80 rows) and on tests/torch_scenes.py's exact ties
    (the lowest grouped index wins a tie across tiles as within one)."""
    from cpppathtracer_tpu_torch.models.scene import SceneBuilder
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
        build_geom_rows, winner_t_index_plain,
    )
    from cpppathtracer_tpu_torch.types import INF

    from torch_scenes import tie_rays, tie_scene

    rng = np.random.RandomState(5)
    b = SceneBuilder()
    for _ in range(37):
        b.add_sphere(tuple(rng.uniform(-10, 10, 3)), float(rng.uniform(0.3, 2.0)))
    b.add_platform(-11.0)
    for _ in range(29):
        b.add_cylinder(tuple(rng.uniform(-10, 10, 3)), float(rng.uniform(0.3, 2.0)),
                       float(rng.uniform(0.5, 4.0)))
    r = 4096
    o = _t(rng.uniform(-15, 15, (3, r)).astype(np.float32))
    d = _t(_rand_unit(r, rng).T.astype(np.float32))
    random_rays = (tuple(o), tuple(d), torch.zeros(r), torch.full((r,), INF))
    for scene, ray in ((b.build(device="cpu", bvh=False), random_rays),
                       (tie_scene(), tie_rays(r))):
        gs = fast.group_scene(scene)
        geom = build_geom_rows(gs)
        assert geom.shape[0] > tile_rows
        t1, i1 = winner_t_index_plain(gs.counts, *ray, geom, tile_rows=geom.shape[0])
        tn, i_n = winner_t_index_plain(gs.counts, *ray, geom, tile_rows=tile_rows)
        assert (i1 > 0).float().mean() > 0.25
        assert torch.equal(i1, i_n) and torch.equal(t1.view(torch.int32), tn.view(torch.int32))


def test_route_a_textured_render_matches_jax(route_a):
    """A textured route A render (the platform and the first sphere
    textured, surface_uv in the bounce), 16x12, 1 spp, depth 3: at least
    95% of the pixels within 5e-5 of the JAX package's (measured 100%)."""
    b = JSceneBuilder()
    b.add_platform(0.0, kd=(0.8, 0.8, 0.8), tex_id=0)
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.3, 0.2), tex_id=1)
    b.add_sphere((2.0, 1.0, -3.0), 1.0, kd=(1.0, 0.9, 0.7), emission=2.0)
    b.add_cylinder((-4.5, 1.5, 0.0), 1.2, 3.0, mat_type=MaterialType.METAL, smoothness=0.8)
    jscene = b.build()
    tex = np.random.RandomState(5).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    ref_out = np.asarray(j_render_radiance(jscene, _jcam(), jnp.asarray(SKY), spp=1, max_depth=3,
                                           seed=0, tex_stack=jnp.asarray(tex))[0])
    got = render_radiance(port_scene(jscene), port_camera(_jcam()), port_sky(SKY), spp=1,
                          max_depth=3, seed=0, tex_stack=_t(tex))[0]
    close = np.isclose(_n(got), ref_out, rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.95, close.mean()


@pytest.mark.parametrize("batch", ["flat", "2d"])
def test_route_b_render_matches_jax(monkeypatch, batch):
    """A scene without type metadata takes the row-major body with the
    dense intersect in both packages, whatever the switches, and launches
    no kernel.  Flat: demo_scene(0) reversed and stripped, the bench
    camera, 32x24, 1 spp, depth 3 through render_radiance: at least 92% of
    the pixels within 1e-4 (measured 93.4%), first-hit t within 5e-5
    relative (measured 1.7e-5) and normals within 2e-3 (measured 9.6e-4:
    the scene's coordinates reach 550, where one ulp is 6e-5, and the hit
    position's rounding over a small radius moves a normal that far).
    2-D: the controlled scene padded to 8 objects, reversed and stripped,
    render_sample on a 12x16 pixel batch: radiance (12, 16, 3), equal to
    the flat sample reshaped, at least 96% of the pixels within 5e-5 of
    JAX's 2-D sample (measured 97.9%), t within 5e-6 relative, normals
    within 5e-5."""
    monkeypatch.delenv("POCA_MEGA", raising=False)
    monkeypatch.delenv("POCA_PLANAR", raising=False)
    sky = port_sky(SKY)
    kb.reset_launches()
    if batch == "flat":
        jscene = j_demo_scene(seed=0).build()
        jbare = _strip(jscene, lambda a: a[::-1])
        bare = _strip(port_scene(jscene), lambda a: a.flip(0))
        jcam = JCamera.make(32, 24, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
        ref_out = [np.asarray(a) for a in j_render_radiance(jbare, jcam, jnp.asarray(SKY), spp=1,
                                                            max_depth=3, seed=0)]
        got = [_n(a) for a in render_radiance(bare, port_camera(jcam), sky, spp=1, max_depth=3,
                                              seed=0)]
        share, atol, t_rtol, n_atol = 0.92, 1e-4, 5e-5, 2e-3
    else:
        jscene = controlled_scene(pad_to=8)
        jbare = _strip(jscene, lambda a: a[::-1])
        bare = _strip(port_scene(jscene), lambda a: a.flip(0))
        cam = port_camera(_jcam())
        pix = np.arange(16 * 12, dtype=np.int32).reshape(12, 16)
        ref_out = [np.asarray(a) for a in j_render_sample(jbare, _jcam(), jnp.asarray(SKY),
                                                          jnp.asarray(pix), 1, 0, 4)]
        got = [_n(a) for a in render_sample(bare, cam, sky, _t(pix), 1, 0, 4)]
        flat = render_sample(bare, cam, sky, _t(pix.ravel()), 1, 0, 4)
        assert got[0].shape == (12, 16, 3) and got[1].shape == (12, 16, 3)
        assert got[2].shape == (12, 16)
        for a, b in zip(got, flat):
            np.testing.assert_array_equal(a, _n(b).reshape(a.shape))
        share, atol, t_rtol, n_atol = 0.96, 5e-5, 5e-6, 5e-5
    assert fast.group_scene(bare) is None
    assert not any(kb.LAUNCHES.values())
    close = np.isclose(got[0], ref_out[0], rtol=0, atol=atol).all(-1)
    assert close.mean() >= share, close.mean()
    np.testing.assert_allclose(got[2], ref_out[2], rtol=t_rtol)
    np.testing.assert_allclose(got[1], ref_out[1], atol=n_atol)


def test_grouped_2d_batch_raises_as_jax():
    """A grouped scene renders flat pixel indices only: a 2-D batch raises
    TypeError in the JAX package (its grouped search's dot_general) and in
    the port (fast.intersect_and_gather)."""
    jscene = controlled_scene()
    pix = np.arange(16 * 12, dtype=np.int32).reshape(12, 16)
    with pytest.raises(TypeError):
        j_render_sample(jscene, _jcam(), jnp.asarray(SKY), jnp.asarray(pix), 0, 0, 2)
    with pytest.raises(TypeError):
        render_sample(port_scene(jscene), port_camera(_jcam()), port_sky(SKY), _t(pix), 0, 0, 2)


def test_route_a_grads_match_jax(route_a):
    """bench.py's loss sum(rad^2) on route A (12x8, 2 spp, depth 3, the
    controlled scene): every material field's gradient, the sky's and the
    camera origin's against jax.grad of the JAX package's row-major body,
    on the pixels whose radiance agrees within 1e-5 (at least 90%), at
    tests/test_torch_grad.py's bounds."""
    fields = ("kd", "emission", "smoothness", "reflectivity", "ior")
    jscene = controlled_scene()
    jcam = JCamera.make(12, 8, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))
    mask = _agreeing_pixels(jscene, jcam, SKY, 2, 3)
    assert mask.mean() >= 0.9, mask.mean()
    got = _port_grads(jscene, jcam, SKY, 2, 3, fields, mask, sky_origin=True)
    want = _jax_grads(jscene, jcam, SKY, 2, 3, fields, mask, sky_origin=True)
    assert np.abs(want["kd"]).max() > 0 and np.abs(want["sky"]).max() > 0
    for k in fields + ("sky",):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["origin"], want["origin"], rtol=1e-2, atol=1e-2)
