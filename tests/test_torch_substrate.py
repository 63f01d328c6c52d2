"""The port's substrate against the JAX package on the same inputs: RNG,
math, the planar bounce body, scene tables, camera rays and sky sampling.
Inputs are made with numpy from fixed seeds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops import fast as j_fast
from cpppathtracer_tpu.ops import mathx as j_mathx
from cpppathtracer_tpu.ops import planar as j_planar
from cpppathtracer_tpu.ops import texture as j_texture
from cpppathtracer_tpu.ops.pallas.intersect_kernel import build_geom_rows as j_geom_rows
from cpppathtracer_tpu.ops.pallas.mega_kernel import build_tables_T as j_tables_T
from cpppathtracer_tpu.utils.rng import uniforms4_np
from cpppathtracer_tpu_torch.models.scene import demo_scene
from cpppathtracer_tpu_torch.ops import mathx, planar, texture
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T
from cpppathtracer_tpu_torch.ops.fast import group_scene
from cpppathtracer_tpu_torch.utils.rng import uniforms4

from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(a):
    return np.asarray(a)


# ---------------------------------------------------------------- RNG


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_rng_bitwise_equal_to_numpy(seed):
    """Bitwise: 12,288 keys per seed, pixels crossing 2^31."""
    rng = np.random.RandomState(seed % 1000)
    pixels = np.concatenate([
        np.arange(4096, dtype=np.uint32),
        rng.randint(0, 2**32 - 1, size=8192, dtype=np.uint64).astype(np.uint32),
    ])
    for sample, ctr in ((0, 0), (17, 3), (65535, 9)):
        ref = uniforms4_np(np.uint32(seed), pixels, np.uint32(sample), np.uint32(ctr))
        got = uniforms4(seed, _t(pixels.astype(np.int64)), sample, ctr)
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b)


def test_rng_per_lane_sample_keys():
    pixels = np.arange(2048, dtype=np.uint32)
    samples = (pixels * 7 % 64).astype(np.uint32)
    ref = uniforms4_np(np.uint32(3), pixels, samples, np.uint32(2))
    got = uniforms4(3, _t(pixels.astype(np.int32)), _t(samples.astype(np.int32)), 2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------------- math + planar

@pytest.fixture
def rng():
    """Each test's own inputs, whatever ran before it."""
    return np.random.RandomState(5)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_schlick_matches_jax(rng):
    cos = rng.uniform(-0.2, 1.0, 4096).astype(np.float32)
    ior = rng.uniform(1.0, 3.0, 4096).astype(np.float32)
    np.testing.assert_allclose(
        mathx.schlick(_t(cos), _t(ior)).numpy(),
        _n(j_mathx.schlick(jnp.asarray(cos), jnp.asarray(ior))), rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("mat_type", [0, 1, 2, 3])
def test_shade_p_matches_jax(rng, mat_type):
    """All four materials; allclose at 1e-6 (float32 library functions
    differ in the last ulp between PyTorch and XLA)."""
    n = 4096
    normal = _unit(rng, n)
    in_dir = _unit(rng, n)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    kd = rng.uniform(0, 1, (3, n)).astype(np.float32)
    fields = dict(
        mat_type=np.full(n, mat_type, np.int32),
        emission=rng.uniform(0, 2, n).astype(np.float32),
        smoothness=rng.uniform(0, 1.2, n).astype(np.float32),
        reflectivity=rng.uniform(0, 1, n).astype(np.float32),
        ior=rng.uniform(1.1, 2.5, n).astype(np.float32),
    )
    jm = {k: jnp.asarray(v) for k, v in fields.items()}
    jm["kd_p"] = tuple(jnp.asarray(c) for c in kd)
    tm = {k: _t(v) for k, v in fields.items()}
    tm["kd_p"] = tuple(_t(c) for c in kd)
    ref = j_planar.shade_p(
        jm, tuple(jnp.asarray(c) for c in normal.T), tuple(jnp.asarray(c) for c in in_dir.T),
        *(jnp.asarray(c) for c in u), score_grad=False,
    )
    got = planar.shade_p(
        tm, tuple(_t(c) for c in normal.T), tuple(_t(c) for c in in_dir.T), *(_t(c) for c in u)
    )
    for name, g, r in zip(("bounce", "atten", "emitted"), got, ref):
        for c in range(3):
            np.testing.assert_allclose(g[c].numpy(), _n(r[c]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name}[{c}]")


@pytest.mark.parametrize("prim", [0, 1, 2])
def test_object_hit_attrs_p_matches_jax(rng, prim):
    """Each primitive against rays aimed near it: equal hit masks, t at
    rtol 1e-6 and normals at 1e-6 where hit."""
    n = 4096
    center = np.stack([rng.uniform(-5, 5, n), rng.uniform(0.5, 4, n), rng.uniform(-5, 5, n)]).astype(np.float32)
    radius = rng.uniform(-2, 3, n).astype(np.float32)
    y_pos = rng.uniform(-1, 2, n).astype(np.float32)
    height = rng.uniform(0.5, 4, n).astype(np.float32)
    o = (center + rng.uniform(-12, 12, (3, n))).astype(np.float32)
    aim = (center + rng.uniform(-2, 2, (3, n)) - o).astype(np.float32)
    d = (aim / np.linalg.norm(aim, axis=0)).astype(np.float32)
    tmin = np.where(rng.uniform(size=n) < 0.5, 0.0, 2e-5).astype(np.float32)
    tmax = np.full(n, 1e30, np.float32)
    prim_t = np.full(n, prim, np.int32)
    args = [prim_t, tuple(center), radius, y_pos, height, tuple(o), tuple(d), tmin, tmax]
    conv = lambda f, a: tuple(f(c) for c in a) if isinstance(a, tuple) else f(a)
    t_r, n_r = j_planar.object_hit_attrs_p(*[conv(jnp.asarray, a) for a in args])
    t_g, n_g = planar.object_hit_attrs_p(*[conv(_t, a) for a in args])
    t_r = _n(t_r)
    hit = t_r < 1e30
    assert 0.2 < hit.mean()
    np.testing.assert_array_equal(t_g.numpy() < 1e30, hit)
    np.testing.assert_allclose(t_g.numpy()[hit], t_r[hit], rtol=1e-6)
    for c in range(3):
        np.testing.assert_allclose(n_g[c].numpy()[hit], _n(n_r[c])[hit], atol=1e-6)


# ------------------------------------------------------------ scene tables


@pytest.mark.parametrize("make", [lambda: j_demo_scene(seed=0).build(), controlled_scene],
                         ids=["demo", "controlled"])
def test_scene_tables_exactly_equal(make):
    jscene = make()
    scene = port_scene(jscene)
    jgs = j_fast.group_scene(jscene)
    gs = group_scene(scene)
    assert gs.counts == jgs.counts
    np.testing.assert_array_equal(gs.table_s.numpy(), _n(jgs.table_s))
    np.testing.assert_array_equal(gs.table_r.numpy(), _n(jgs.table_r))
    np.testing.assert_array_equal(build_geom_rows(gs).numpy(), _n(j_geom_rows(jgs)))
    for a, b in zip(build_tables_T(gs), j_tables_T(jgs)):
        np.testing.assert_array_equal(a.numpy(), _n(b))


def test_port_demo_scene_matches_jax():
    """The port's own demo_scene builds the same tables as the JAX one."""
    jscene = j_demo_scene(seed=0).build()
    scene = demo_scene(0).build(device="cpu")
    assert scene.type_counts == (54, 1, 38) == jscene.type_counts
    assert scene.type_perm == jscene.type_perm
    for k in ("center", "radius", "height", "kd", "smoothness", "ior", "mat_type"):
        np.testing.assert_array_equal(getattr(scene, k).numpy(), _n(getattr(jscene, k)))


# --------------------------------------------------------- camera + texture


def test_camera_rays_match_jax():
    """Planar primaries allclose at 1e-6, also after a motion op and the
    deg/rad ScaleFov quirk."""
    jcam = JCamera.make(48, 32, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
    for op in (lambda c: c, lambda c: c.move_forward(0.3).rotate_left(0.05).scale_fov(4.0)):
        jc = op(jcam)
        cam = port_camera(jc)
        pix = np.arange(48 * 32, dtype=np.int32)
        jo, jd = jc.ray_gen_planar(jnp.asarray(pix), 3, 11)
        o, d = cam.ray_gen_planar(_t(pix), 3, 11)
        for a, b in zip(o + d, jo + jd):
            np.testing.assert_allclose(a.numpy(), _n(b), rtol=1e-6, atol=1e-6)
    moved = port_camera(jcam).move_forward(0.3).rotate_left(0.05).scale_fov(4.0)
    jmoved = jcam.move_forward(0.3).rotate_left(0.05).scale_fov(4.0)
    for k in ("origin", "look_at", "view_fov"):
        np.testing.assert_allclose(getattr(moved, k).numpy(), _n(getattr(jmoved, k)), rtol=1e-6)


@pytest.mark.parametrize("op", ["move_left", "move_right", "move_forward", "move_backward",
                                "move_up", "move_down", "rotate_up", "rotate_down",
                                "rotate_left", "rotate_right", "scale_fov"])
def test_camera_motion_matches_jax(op):
    """Each motion op gives the JAX camera's origin, look_at and fov,
    allclose at 1e-6."""
    jcam = JCamera.make(48, 32, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
    arg = {"move": 0.7, "rota": 0.05, "scal": 4.0}[op[:4]]
    jc = getattr(jcam, op)(arg)
    cam = getattr(port_camera(jcam), op)(arg)
    for k in ("origin", "look_at", "view_fov"):
        np.testing.assert_allclose(getattr(cam, k).numpy(), _n(getattr(jc, k)), rtol=1e-6, atol=1e-6)


def test_ray_gen_after_resize_matches_jax():
    """The row-major ray_gen of a resized camera, allclose at 1e-6."""
    jcam = JCamera.make(48, 32, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
    cam = port_camera(jcam).resize(40, 20)
    jcam = jcam.resize(40, 20)
    pix = np.arange(40 * 20, dtype=np.int32)
    jr = jcam.ray_gen(jnp.asarray(pix), 2, 5)
    o, d = cam.ray_gen(_t(pix), 2, 5)
    assert o.shape == d.shape == (800, 3)
    np.testing.assert_allclose(o.numpy(), _n(jr.origin), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), _n(jr.dir), rtol=1e-6, atol=1e-6)


def test_material_params_match_jax():
    """material_params holds the JAX scene's five material fields; a
    with_material_params round trip changes only them."""
    scene = demo_scene(0).build(device="cpu")
    jparams = j_demo_scene(seed=0).build().material_params()
    params = scene.material_params()
    assert set(params) == set(jparams)
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), _n(jparams[k]))
    halved = scene.with_material_params({k: v * 0.5 for k, v in params.items()})
    for k, v in halved.material_params().items():
        assert torch.equal(v, params[k] * 0.5)
    assert torch.equal(halved.center, scene.center) and halved.type_perm == scene.type_perm


def test_sample_sky_packed_matches_jax(rng):
    """Directions to sky colours, allclose at 1e-6.  XLA's asin and atan
    differ from PyTorch's by an ulp on some inputs, and the sky's slope
    (the sun disc, 32 texels per unit of v) turns an ulp of v into up to
    ~2e-6 of colour, so the (u, v) mapping and the packed fetch on
    identical (u, v) are held at 1e-6 separately as well."""
    sky = j_texture.procedural_sky(32, 48, seed=2)
    dirs = _unit(rng, 8192)
    dirs[:16, 0] = 0.0  # the guarded d.x == 0 case
    jpt = j_texture.pack_bilinear(jnp.asarray(sky))
    pt = texture.pack_bilinear(port_sky(sky))
    ref = j_texture.sample_sky_packed(jpt, jnp.asarray(dirs))
    got = texture.sample_sky_packed(pt, _t(dirs))
    np.testing.assert_allclose(got.numpy(), _n(ref), rtol=1e-6, atol=1e-6)
    for a, b in zip(texture.sky_uv(_t(dirs)), j_texture.sky_uv(jnp.asarray(dirs))):
        np.testing.assert_allclose(a.numpy(), _n(b), rtol=1e-6, atol=1e-7)
    # the fetch itself, with mirror folding, on identical coordinates
    u = rng.uniform(-1.5, 1.5, 8192).astype(np.float32)
    v = rng.uniform(-1.5, 1.5, 8192).astype(np.float32)
    np.testing.assert_allclose(
        texture.sample_packed(pt, _t(u), _t(v)).numpy(),
        _n(j_texture.sample_packed(jpt, jnp.asarray(u), jnp.asarray(v))), rtol=1e-6, atol=1e-6,
    )
    # the direct mirror-addressed bilinear fetch agrees too
    u = rng.uniform(-1.5, 1.5, 2048).astype(np.float32)
    v = rng.uniform(-1.5, 1.5, 2048).astype(np.float32)
    np.testing.assert_allclose(
        texture.sample_bilinear(_t(sky), _t(u), _t(v)).numpy(),
        _n(j_texture.sample_bilinear(jnp.asarray(sky), jnp.asarray(u), jnp.asarray(v))),
        rtol=1e-6, atol=1e-6,
    )


def test_procedural_sky_and_load_texture_match_jax():
    np.testing.assert_array_equal(texture.procedural_sky(64, 32, 3), j_texture.procedural_sky(64, 32, 3))
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "assets" / "sky.png"
    np.testing.assert_array_equal(texture.load_texture(path), j_texture.load_texture(path))
