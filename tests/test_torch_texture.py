"""Textured albedo and the wavefront path's gradients in the port against
the JAX package: `surface_uv_p` and `shade_p(kd_override=)`, twins of
tests/test_albedo_texture.py, textured radiance on both port paths,
gradients through the wavefront path (BVH and POCA_MEGA=0) with the
saved-winner replay, and the repairs of POCA_SPP_CHUNK and of the
megakernel's shared-memory check.

The JAX side runs as its own tests run it on the CPU: its default
bounce-loop (wavefront) path.  Inputs come from numpy seeds and reach the
port through ``cpppathtracer_tpu_torch.convert``.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.integrator import render_sample as j_render_sample
from cpppathtracer_tpu.models import presets as jpresets
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops import fast as j_fast
from cpppathtracer_tpu.ops import planar as j_planar
from cpppathtracer_tpu.ops.mega import _replay_chain as j_replay_chain
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu.ops.uv import surface_uv_p as j_surface_uv_p
from cpppathtracer_tpu.types import MaterialType, PrimitiveType
from cpppathtracer_tpu_torch import convert, integrator
from cpppathtracer_tpu_torch.integrator import render_radiance, render_sample
from cpppathtracer_tpu_torch.ops import fast, mega, planar
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import (
    build_tables_T,
    check_mega_smem,
    mega_smem_bytes,
    mega_trace_plain,
)
from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd
from cpppathtracer_tpu_torch.ops.uv import surface_uv_p

from test_torch_grad import (
    FIELDS, _agreeing_pixels, _jax_grads, _lane_close, _port_grads, _rehits, _sample_setup,
)
from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

SKY = procedural_sky(16, 16, seed=0)
H100_SMEM_OPTIN = 232448


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tex(tex):
    return convert.tex_stack_from_numpy(tex, device="cpu")


def _checker(green):
    """The JAX test's 8x8 checker texture: 0.9 on alternate cells, the
    green channel `green` everywhere."""
    tex = np.zeros((1, 8, 8, 3), np.float32)
    tex[0, ::2, ::2] = 0.9
    tex[0, 1::2, 1::2] = 0.9
    tex[0, :, :, 1] = green
    return tex


# ------------------------------------------------------------ (1) the parts


@pytest.mark.parametrize("prim", [PrimitiveType.SPHERE, PrimitiveType.PLATFORM,
                                  PrimitiveType.CYLINDER], ids=["sphere", "platform", "cylinder"])
def test_surface_uv_p_matches_jax(prim):
    """Random hit positions on (and near) objects of one type, a few with
    zero radius or height (the guards): u and v within 1e-6 (atan2 and
    asin differ by ulps between XLA's CPU code and PyTorch)."""
    rng = np.random.RandomState(int(prim) + 10)
    n = 4096
    center = rng.uniform(-50, 50, (3, n)).astype(np.float32)
    radius = rng.uniform(0.2, 5.0, n).astype(np.float32)
    height = rng.uniform(0.5, 8.0, n).astype(np.float32)
    radius[:16], height[16:32] = 0.0, 0.0
    y_pos = rng.uniform(-1, 1, n).astype(np.float32)
    unit = rng.normal(size=(3, n))
    unit /= np.linalg.norm(unit, axis=0)
    pos = (center + unit * radius * rng.uniform(0.9, 1.1, n)).astype(np.float32)
    prim_t = np.full(n, int(prim), np.int32)
    args = lambda conv: (conv(prim_t), tuple(conv(c) for c in center), conv(radius),
                         conv(y_pos), conv(height), tuple(conv(c) for c in pos))
    u_j, v_j = j_surface_uv_p(*args(jnp.asarray))
    u, v = surface_uv_p(*args(_t))
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-6, atol=1e-6)


def test_shade_p_kd_override_matches_jax():
    """shade_p with kd_override on 4096 lanes of every material type, at
    tests/test_torch_substrate.py's shade_p tolerance (1e-6): the override
    moves the attenuation, and the emission still reads the raw kd."""
    rng = np.random.RandomState(5)
    n = 4096
    unit = lambda: (lambda v: (v / np.linalg.norm(v, axis=0)).astype(np.float32))(
        rng.normal(size=(3, n)))
    normal, in_dir = unit(), unit()
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    kd = rng.uniform(0, 1, (3, n)).astype(np.float32)
    kd_o = rng.uniform(0, 1, (3, n)).astype(np.float32)
    fields = dict(
        mat_type=rng.randint(0, 5, n).astype(np.int32),
        emission=rng.uniform(0, 2, n).astype(np.float32),
        smoothness=rng.uniform(0, 1.2, n).astype(np.float32),
        reflectivity=rng.uniform(0, 1, n).astype(np.float32),
        ior=rng.uniform(1.1, 2.5, n).astype(np.float32),
    )

    def run(shade_p, conv, **kw):
        m = {k: conv(v) for k, v in fields.items()}
        m["kd_p"] = tuple(conv(c) for c in kd)
        return shade_p(m, tuple(conv(c) for c in normal), tuple(conv(c) for c in in_dir),
                       *(conv(c) for c in u), kd_override=tuple(conv(c) for c in kd_o),
                       score_grad=False)

    ref = run(j_planar.shade_p, jnp.asarray)
    got = run(planar.shade_p, _t)
    for name, g, r in zip(("bounce", "atten", "emitted"), got, ref):
        for c in range(3):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(r[c]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name}[{c}]")
    on = got[1][0].numpy() != 0
    assert on.any()
    np.testing.assert_array_equal(got[1][0].numpy()[on], kd_o[0][on])
    np.testing.assert_array_equal(got[2][0].numpy(), (kd[0] * fields["emission"]))


# ------------------------------------------------ (3) test_albedo_texture's twins


def _setup(tex_id, **platform):
    """tests/test_albedo_texture.py's scene: an emissive dome over a
    platform seen from 40 units up with a 90-degree lens, 8x8 pixels; the
    JAX objects and their port counterparts."""
    b = JSceneBuilder()
    b.add_sphere((0.0, 0.0, 0.0), 500.0, kd=(1.0, 1.0, 1.0), emission=1.0)
    b.add_platform(0.0, kd=platform.pop("kd", (0.5, 0.5, 0.5)), tex_id=tex_id, **platform)
    jscene = b.build()
    jcam = JCamera.make(8, 8, origin=(0.0, 40.0, -1.0), look_at=(0.0, 0.0, 0.0),
                        lens_radius=0.0, view_fov=90.0)
    return jscene, jcam, port_scene(jscene), port_camera(jcam)


PIX = torch.arange(64, dtype=torch.int32)


def test_textured_albedo_changes_attenuation():
    """The checker spreads the radiance beyond the flat-kd render (the JAX
    test's assertions), and the textured render equals the JAX package's
    within 1e-5."""
    tex = np.zeros((1, 8, 8, 3), np.float32)
    tex[0, ::2, ::2] = 1.0
    tex[0, 1::2, 1::2] = 1.0
    jscene, jcam, scene_t, cam = _setup(0)
    sky = port_sky(SKY)
    rad_tex = render_sample(scene_t, cam, sky, PIX, 0, 0, 2, tex_stack=_tex(tex))[0].numpy()
    rad_flat = render_sample(_setup(-1)[2], cam, sky, PIX, 0, 0, 2, tex_stack=_tex(tex))[0].numpy()
    assert not np.allclose(rad_tex, rad_flat)
    assert rad_tex.min() < 0.15
    assert rad_tex.max() > rad_flat.max()
    assert rad_tex.std() > 2.0 * rad_flat.std()
    ref = np.asarray(j_render_sample(jscene, jcam, jnp.asarray(SKY), jnp.asarray(PIX.numpy()), 0,
                                     0, 2, tex_stack=jnp.asarray(tex))[0])
    np.testing.assert_allclose(rad_tex, ref, rtol=1e-5, atol=1e-5)


def test_no_texture_matches_baseline():
    """A stack that no object uses gives the no-stack render bitwise."""
    tex = np.random.RandomState(0).uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    _, _, scene, cam = _setup(-1)
    sky = port_sky(SKY)
    with_tex = render_sample(scene, cam, sky, PIX, 0, 0, 3, tex_stack=_tex(tex))
    none = render_sample(scene, cam, sky, PIX, 0, 0, 3)
    for a, b in zip(with_tex, none):
        assert torch.equal(a, b)


def test_emission_uses_plain_kd():
    """A black texture on an emitter: the emission reads the raw kd
    (material.cu:36), so the radiance is kd * emission = 1."""
    b = JSceneBuilder()
    b.add_sphere((0.0, 0.0, 5.0), 2.0, kd=(0.5, 0.5, 0.5), emission=2.0, tex_id=0)
    scene = port_scene(b.build())
    cam = port_camera(JCamera.make(4, 4, origin=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, 5.0),
                                   lens_radius=0.0))
    rad, _, _ = render_sample(scene, cam, port_sky(SKY), PIX[:16], 0, 0, 1,
                              tex_stack=_tex(np.zeros((1, 4, 4, 3), np.float32)))
    np.testing.assert_allclose(rad.numpy(), 1.0, atol=1e-5)


def _loss_grads(scene, cam, tex, fields, monkeypatch, use_mega, depth=2):
    """sum(rad^2) of the port's textured render at 1 spp and its gradients
    w.r.t. `fields` of the scene and the texture stack."""
    monkeypatch.setenv("POCA_MEGA", "1" if use_mega else "0")
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in fields}
    leaves["tex"] = _tex(tex).requires_grad_()
    s = scene.with_material_params({k: leaves[k] for k in fields})
    rad, _, _ = render_radiance(s, cam, port_sky(SKY), spp=1, max_depth=depth, seed=0,
                                tex_stack=leaves["tex"])
    grads = torch.autograd.grad((rad * rad).sum(), list(leaves.values()))
    return rad.detach().numpy(), {k: g.numpy() for k, g in zip(leaves, grads)}


def _cos_ratio(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12), \
        np.linalg.norm(b) / (np.linalg.norm(a) + 1e-12)


def test_mega_path_textured_matches_wavefront(monkeypatch):
    """The megakernel path with the texture epilogue against the wavefront
    path: radiance on at least 95% of the pixels within 2e-5, and the kd
    and texture gradients with cosine > 0.999 and norms within 3% (the
    JAX test's bounds); the texture gradient is nonzero."""
    _, _, scene, cam = _setup(0)
    tex = _checker(0.4)
    rad_w, g_w = _loss_grads(scene, cam, tex, ("kd",), monkeypatch, use_mega=False)
    rad_m, g_m = _loss_grads(scene, cam, tex, ("kd",), monkeypatch, use_mega=True)
    close = np.abs(rad_m - rad_w).max(-1) <= 2e-5
    assert close.mean() > 0.95, close.mean()
    for k in ("kd", "tex"):
        cos, ratio = _cos_ratio(g_w[k], g_m[k])
        assert cos > 0.999 and abs(ratio - 1) < 0.03, (k, cos, ratio)
    assert np.abs(g_m["tex"]).sum() > 0


@functools.lru_cache(maxsize=None)
def _jax_dome_grads(platform_tex):
    """jax.grad of sum(rad^2) of the JAX package's wavefront render of the
    dome scene (the checker, 1 spp, depth 2) w.r.t. kd and the stack."""
    jscene, jcam, _, _ = _setup(platform_tex)

    def loss(kd, t):
        s = dataclasses.replace(jscene, kd=kd)
        rad, _, _ = j_render_radiance(s, jcam, jnp.asarray(SKY), spp=1, max_depth=2, seed=0,
                                      tex_stack=t)
        return jnp.sum(rad * rad)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(jscene.kd, jnp.asarray(_checker(0.4)))
    return tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("path", ["mega", "wavefront"])
@pytest.mark.parametrize("platform_tex", [0, -1], ids=["textured", "plain"])
def test_textured_grads_match_jax(monkeypatch, path, platform_tex):
    """kd and texture-stack gradients of sum(rad^2) on the dome scene (the
    checker, 1 spp, depth 2) on each port path against jax.grad of the
    JAX package's wavefront render, at tests/test_torch_grad.py's rtol
    1e-3, atol 1e-3.  Textured, the platform's kd takes no gradient and
    the texture does; plain (tex_id -1, the stack passed), the platform's
    kd takes it through the attenuation and the texture none."""
    _, _, scene, cam = _setup(platform_tex)
    _, got = _loss_grads(scene, cam, _checker(0.4), ("kd",), monkeypatch, use_mega=path == "mega")
    monkeypatch.delenv("POCA_MEGA")
    ref = _jax_dome_grads(platform_tex)
    assert np.abs(ref[0][0]).min() > 0
    assert (np.abs(ref[0][1]).min() > 0) == (platform_tex < 0)
    assert (np.abs(ref[1]).max() > 0) == (platform_tex >= 0)
    np.testing.assert_allclose(got["kd"], ref[0], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["tex"], ref[1], rtol=1e-3, atol=1e-3)


def test_replay_aux_att_carries_score_weight():
    """The replay's aux attenuation plane carries the score-function
    weight: a loss read through it has a nonzero reflectivity gradient,
    while its forward value stays the exact 0/1 mask."""
    jscene, jcam, scene, cam = _setup(0, kd=(0.6, 0.6, 0.6), mat_type=MaterialType.MIRROR,
                                      smoothness=2.0, reflectivity=0.4)
    gs = fast.group_scene(scene)
    ts, trt = build_tables_T(gs)
    o, d = cam.ray_gen_planar(PIX, torch.zeros(64, dtype=torch.int32), 0)
    out = mega_trace_plain(o, d, PIX, torch.zeros(64, dtype=torch.int32), 0, build_geom_rows(gs),
                           ts, trt, counts=gs.counts, depth=2)
    assert (out[6][0] >= 0).all() and (out[6][1] >= 0).any()
    ts = ts.clone().requires_grad_()
    outs = mega._replay_outputs(o, d, ts, trt, PIX, torch.zeros(64, dtype=torch.int32), 0,
                                out[6], with_aux=True)
    loss = sum(att.sum() for _, att in outs[7])
    (g,) = torch.autograd.grad(loss, ts)
    assert float(loss.detach()) == int(loss.detach())
    assert g[9].abs().sum() > 1e-3, g[9]


@pytest.mark.parametrize("which", ["controlled", "demo"])
def test_replay_vjp_with_aux_matches_jax_replay(which):
    """replay_vjp(ct_aux=...) (mega_bwd_plain's textured form, through the
    wrapper on CPU tensors) against jax.vjp of the JAX package's replay
    chain with `with_aux` on the same winner planes, with seeded random
    cotangents of every output, the 4 x depth aux planes included: the
    rules of tests/test_torch_grad.py::test_replay_grads_match_jax_replay
    (ct_o and ct_d per lane within rtol 1e-4, atol 1e-5 on every lane of
    the controlled scene and 99.5% of the demo's, the demo's re-hit lanes
    zeroed on both sides; table cotangents within rtol 1e-4, atol 1e-5,
    or per column relative L2 1e-4 on the demo)."""
    if which == "controlled":
        jscene = controlled_scene()
        s = _sample_setup(jscene, (0.0, 4.0, -14.0), (0.0, 1.5, 0.0), 16, 12, 3)
        keep = torch.ones(s["pix"].shape[0], dtype=torch.bool)
    else:
        jscene = j_demo_scene(seed=0).build()
        s = _sample_setup(jscene, (130.0, 103.0, 130.0), (0.0, 0.0, 0.0), 32, 24, 3)
        keep = ~_rehits(s)
        assert keep.float().mean() >= 0.88
    r, depth = s["pix"].shape[0], s["hits"].shape[0]
    rng = np.random.RandomState(1)
    ct = rng.normal(size=(13, r)).astype(np.float32)
    ct_aux = rng.normal(size=(4 * depth, r)).astype(np.float32)
    jgs = j_fast.group_scene(jscene)
    hits_j = tuple(jnp.asarray(h.numpy()) for h in s["hits"])

    def replay(o, d, tables):
        gs_ = dataclasses.replace(jgs, table_s=tables[0], table_r=tables[1])
        z = o[0] * 0.0
        one = z + 1.0
        _, d2, thru, rad, _, fn, ft, aux = j_replay_chain(
            gs_, o, d, (one, one, one), (z, z, z), z < 1.0, hits_j,
            jnp.asarray(s["pix"].numpy()), jnp.asarray(s["samp"].numpy()), s["seed"], 0, True,
        )
        return rad, d2, thru, fn, ft, tuple(aux)

    jv = lambda v: tuple(jnp.asarray(c.numpy()) for c in v)
    _, vjp = jax.vjp(replay, jv(s["o"]), jv(s["d"]), (jgs.table_s, jgs.table_r))

    def both(keep):
        c, ca = ct * keep.numpy(), ct_aux * keep.numpy()
        got = mega_bwd(s["o"], s["d"], s["pix"], s["samp"], s["seed"], s["ts"], s["trt"],
                       s["hits"], list(_t(c)), ct_aux=_t(ca))
        c, ca = [jnp.asarray(x) for x in c], [jnp.asarray(x) for x in ca]
        aux = tuple((tuple(ca[4 * b:4 * b + 3]), ca[4 * b + 3]) for b in range(depth))
        ref = vjp((tuple(c[0:3]), tuple(c[3:6]), tuple(c[6:9]), tuple(c[9:12]), c[12], aux))
        return got, ref

    got, (go, gd, _) = both(keep)
    lanes = [_lane_close(torch.stack(g), _t(np.stack(g_j))) for g, g_j in ((got[2], go), (got[3], gd))]
    close = lanes[0] & lanes[1]
    assert close.float().mean() >= (1.0 if which == "controlled" else 0.995)
    got, (_, _, (g_ts, g_trt)) = both(keep & close)
    na = sum(s["gs"].counts)
    for g, g_j in ((got[0], g_ts), (got[1], g_trt)):
        g, g_j = g.numpy().T[:na], np.asarray(g_j)[:na]
        if which == "controlled":
            np.testing.assert_allclose(g, g_j, rtol=1e-4, atol=1e-5)
        else:
            err = np.linalg.norm(g - g_j, axis=0) / np.maximum(np.linalg.norm(g_j, axis=0), 1e-30)
            assert err.max() <= 1e-4, err


def test_mega_textured_reflectivity_grad_matches_jax(monkeypatch):
    """The port's megakernel path on the textured mirror platform: its
    reflectivity gradient (the score-function term through the aux
    attenuation) against the JAX package's wavefront path, rtol 2e-2
    (the JAX test's bound for its mega path against its wavefront path)."""
    jscene, jcam, scene, cam = _setup(0, kd=(0.6, 0.6, 0.6), mat_type=MaterialType.MIRROR,
                                      smoothness=2.0, reflectivity=0.4)
    tex = _checker(0.5)
    _, g = _loss_grads(scene, cam, tex, ("reflectivity",), monkeypatch, use_mega=True)

    def loss(refl):
        s = dataclasses.replace(jscene, reflectivity=refl)
        rad, _, _ = j_render_radiance(s, jcam, jnp.asarray(SKY), spp=1, max_depth=2, seed=0,
                                      tex_stack=jnp.asarray(tex))
        return jnp.sum(rad * rad)

    monkeypatch.delenv("POCA_MEGA")
    ref = np.asarray(jax.jit(jax.grad(loss))(jscene.reflectivity))
    assert np.abs(g["reflectivity"]).sum() > 1e-4
    np.testing.assert_allclose(g["reflectivity"], ref, rtol=2e-2, atol=1e-5)


# ------------------------------------------- (4) textured radiance vs the JAX package


def _demo_textured():
    """demo_scene(0) with texture 0 on the platform and 1 on the
    cylinders, the spheres untextured; a stack of two 16x16 textures made
    from a numpy seed."""
    jscene = j_demo_scene(seed=0).build()
    prim = np.asarray(jscene.prim_type)
    tid = np.where(prim == PrimitiveType.PLATFORM, 0,
                   np.where(prim == PrimitiveType.CYLINDER, 1, -1)).astype(np.int32)
    jscene = dataclasses.replace(jscene, tex_id=jnp.asarray(tid))
    tex = np.random.RandomState(11).uniform(0.05, 0.95, (2, 16, 16, 3)).astype(np.float32)
    return jscene, tex


@pytest.mark.parametrize("path", ["mega", "wavefront"])
@pytest.mark.parametrize("which", ["dome", "demo"])
def test_textured_radiance_matches_jax(monkeypatch, which, path):
    """The port's textured render on each of its paths against the JAX
    package's: on the dome scene (12x8 pixels of the checker, 2 spp,
    depth 2, the JAX test's depth) at least 95% of the pixels within 2e-5,
    the JAX package's own mega-vs-wavefront bound (measured 100% on both paths); on the
    textured demo scene (32x24, 2 spp, depth 4) tests/test_torch_render.py's
    rule, 80% within 1e-4 (measured 84.6%) and the mean within 2%
    (secondary rays there flip re-hit decisions between XLA's rounding and
    PyTorch's)."""
    if which == "dome":
        jscene, _, _, _ = _setup(0)
        jcam = JCamera.make(12, 8, origin=(0.0, 40.0, -1.0), look_at=(0.0, 0.0, 0.0),
                            lens_radius=0.0, view_fov=90.0)
        tex, kw, share, tol = _checker(0.4), dict(spp=2, max_depth=2), 0.95, 2e-5
    else:
        jscene, tex = _demo_textured()
        jcam = JCamera.make(32, 24, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
        kw, share, tol = dict(spp=2, max_depth=4), 0.80, 1e-4
    ref = np.asarray(j_render_radiance(jscene, jcam, jnp.asarray(SKY), seed=0,
                                       tex_stack=jnp.asarray(tex), **kw)[0])
    monkeypatch.setenv("POCA_MEGA", "1" if path == "mega" else "0")
    with torch.no_grad():
        got = render_radiance(port_scene(jscene), port_camera(jcam), port_sky(SKY), seed=0,
                              tex_stack=_tex(tex), **kw)[0].numpy()
    close = np.abs(got - ref).max(-1) <= tol
    print(f"{which} {path}: {close.mean():.4f} of the pixels within {tol}")
    assert close.mean() >= share, close.mean()
    assert abs(got.mean() / ref.mean() - 1) < 0.02


# -------------------------------------------- (5) gradients through the wavefront path


@pytest.mark.parametrize("which", ["bvh", "dense"])
def test_wavefront_grads_match_jax(monkeypatch, which):
    """The port's wavefront gradients against the JAX package's (its
    wavefront path), under tests/test_torch_grad.py's rules: the loss
    keeps the pixels whose radiance agrees within 1e-5.  bvh:
    big_scene(96) with its BVH (the port walks it), 16x12, 2 spp, depth 3,
    kd and emission with cosine > 0.999 and norms within 5e-3 (the demo
    rule: most rays start far out, as on the demo scene).  dense: the
    controlled scene under POCA_MEGA=0, 12x8, 2 spp, depth 3, every
    material field and the sky within rtol 1e-3, atol 1e-3, the camera
    origin within 1e-2 (the controlled rule)."""
    monkeypatch.setenv("POCA_MEGA", "0")
    if which == "bvh":
        jscene = jpresets.big_scene(96, bvh=True)
        jcam = jpresets.big_camera(96, 16, 12)
        fields, extra, min_share = ("kd", "emission"), False, 0.8
    else:
        jscene = controlled_scene()
        jcam = JCamera.make(12, 8, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))
        fields, extra, min_share = FIELDS, True, 0.9
    assert (port_scene(jscene).bvh_meta is not None) == (which == "bvh")
    sky = procedural_sky(16, 16)
    mask = _agreeing_pixels(jscene, jcam, sky, 2, 3)
    assert mask.mean() >= min_share, mask.mean()
    got = _port_grads(jscene, jcam, sky, 2, 3, fields, mask, sky_origin=extra)
    monkeypatch.delenv("POCA_MEGA")
    ref = _jax_grads(jscene, jcam, sky, 2, 3, fields, mask, sky_origin=extra)
    if which == "bvh":
        for k in fields:
            cos, ratio = _cos_ratio(ref[k], got[k])
            assert cos > 0.999 and abs(ratio - 1) < 5e-3, (k, cos, ratio)
        return
    assert np.abs(ref["sky"]).max() > 0 and np.abs(ref["kd"]).max() > 0
    for k in FIELDS + ("sky",):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["origin"], ref["origin"], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("which", ["bvh", "dense"])
def test_wavefront_backward_replays_saved_winners(monkeypatch, which):
    """The winner function (the BVH walk, or the dense search under
    POCA_MEGA=0) runs `depth` times per sample for forward and backward
    together: the backward replays the saved indices.  And the replay
    recomputes each bounce's hit (t < INF) equal to the forward's on every
    lane, with the same outputs bitwise."""
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene

    scene = big_scene(96, bvh=which == "bvh", device="cpu")
    cam = big_camera(96, 8, 6, device="cpu")
    if which == "dense":
        monkeypatch.setenv("POCA_MEGA", "0")
    name = "bvh_winner_index" if which == "bvh" else "winner_index"
    real, calls = getattr(fast, name), []
    monkeypatch.setattr(fast, name, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kd = scene.kd.clone().requires_grad_()
    rad, _, _ = render_radiance(scene.with_material_params({"kd": kd}), cam, port_sky(SKY),
                                spp=2, max_depth=3)
    assert len(calls) == 2 * 3
    (g,) = torch.autograd.grad((rad * rad).sum(), kd)
    assert len(calls) == 2 * 3 and g.abs().max() > 0

    gs = fast.group_scene(scene)
    pix = torch.arange(48, dtype=torch.int32)
    samp = torch.full((48,), 1, dtype=torch.int32)
    rays = cam.ray_gen_planar(pix, samp, 0)
    with torch.no_grad():
        fwd = integrator.trace_bounces(gs, rays, pix, samp, 0, 3)
    leaves = [t.clone().requires_grad_() for t in (gs.table_s, gs.table_r)]
    rep = integrator.trace_bounces(gs, rays, pix, samp, 0, 3, gidx_planes=fwd[6],
                                   tables=(leaves[0].double(), leaves[1].double()))
    assert len(calls) == 2 * 3 + 3
    for a, b in zip(fwd[7], rep[7]):
        assert torch.equal(a, b)
    flat = lambda out: [*out[0], *out[1], *out[2], out[3], *out[4], out[5]]
    for a, b in zip(flat(fwd), flat(rep)):
        assert torch.equal(a, b.detach())


# ------------------------------------------------------------------ (6) repairs


def test_spp_chunk_env_matches_argument(monkeypatch):
    """POCA_SPP_CHUNK, digits and > 0, overrides the argument as in the
    JAX package: the env's render equals the argument's bitwise, and a
    value that is not a positive integer is ignored."""
    scene = port_scene(controlled_scene())
    cam = port_camera(JCamera.make(12, 8, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0)))
    sky = port_sky(SKY)
    render = lambda chunk: render_radiance(scene, cam, sky, spp=4, max_depth=2, spp_chunk=chunk)
    with torch.no_grad():
        by_arg = render(2)
        monkeypatch.setenv("POCA_SPP_CHUNK", "2")
        by_env = render(1)
        monkeypatch.setenv("POCA_SPP_CHUNK", "0")
        ignored = render(1)
        monkeypatch.delenv("POCA_SPP_CHUNK")
        unchunked = render(1)
    for a, b in zip(by_arg, by_env):
        assert torch.equal(a, b)
    for a, b in zip(ignored, unchunked):
        assert torch.equal(a, b)
    torch.testing.assert_close(by_arg[0], unchunked[0], rtol=1e-6, atol=1e-6)


def test_mega_trace_smem_check():
    """The megakernel's shared memory, 4 (8 n_rep + 17 n_pad) bytes,
    against the H100's opt-in limit: demo_scene(0) (93 objects) fits;
    big_scene(2400) without its BVH does not, and the check names both
    numbers and the remedy."""
    from cpppathtracer_tpu_torch.models.presets import big_scene
    from cpppathtracer_tpu_torch.models.scene import demo_scene

    def shape(scene):
        gs = fast.group_scene(scene)
        return build_geom_rows(gs).shape[0], build_tables_T(gs)[0].shape[1]

    n_rep, n_pad = shape(demo_scene(0).build(device="cpu"))
    assert (n_rep, n_pad) == (104, 96)
    assert mega_smem_bytes(n_rep, n_pad) == 9856
    check_mega_smem(n_rep, n_pad, H100_SMEM_OPTIN)
    n_rep, n_pad = shape(big_scene(2400, bvh=False, device="cpu"))
    need = mega_smem_bytes(n_rep, n_pad)
    assert need > H100_SMEM_OPTIN
    with pytest.raises(ValueError, match=rf"{need} bytes.*{H100_SMEM_OPTIN} bytes.*bvh=True"):
        check_mega_smem(n_rep, n_pad, H100_SMEM_OPTIN)
