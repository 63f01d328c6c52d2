"""The port's per-bounce wavefront path against the JAX package's:
render_radiance on a BVH scene, BVH walk vs dense winner inside the port,
the progressive loop on a stale BVH scene, the path's gradient, and the
presets; and the fused bounce kernel's body (csrc/wavefront.cuh, built for
the host) and loop against the PyTorch body.  (tests/test_torch_texture.py
holds its gradients against the JAX package's.)"""

import ctypes
import dataclasses
import logging
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.models import presets as jpresets
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu_torch import integrator
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.models import presets
from cpppathtracer_tpu_torch.ops import fast, planar
from cpppathtracer_tpu_torch.ops.cuda.wavefront_kernel import (
    bounce_p,
    field_major_tables,
    wavefront_bounce_plain,
)
from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig
from cpppathtracer_tpu_torch.types import INF, TMIN_BOUNCE, MaterialType, PrimitiveType
from cpppathtracer_tpu_torch.utils.rng import _u32_bits

from torch_port_helpers import port_camera, port_scene, port_sky

torch.set_num_threads(1)

SKY = procedural_sky(16, 16, seed=1)
CSRC = Path(__file__).resolve().parents[1] / "cpppathtracer_tpu_torch" / "csrc"
TESTS = Path(__file__).resolve().parent


def _jax_wavefront(monkeypatch, depth):
    """The JAX package's wavefront render of big_scene(220) with its BVH
    (the Pallas walk in interpret mode), 24x16, 2 spp."""
    monkeypatch.setenv("POCA_MEGA", "0")
    monkeypatch.setenv("POCA_PALLAS", "1")
    monkeypatch.setenv("POCA_BVH", "1")
    jscene = jpresets.big_scene(220, bvh=True)
    jcam = jpresets.big_camera(220, 24, 16)
    ref = [np.asarray(a) for a in j_render_radiance(jscene, jcam, jnp.asarray(SKY), spp=2,
                                                    max_depth=depth, seed=0)]
    return port_scene(jscene), port_camera(jcam), ref


def test_wavefront_render_matches_jax_primary(monkeypatch):
    """Depth 1: radiance within 1e-5 (measured: equal), so every pixel saw
    the same object.  The first-hit t and normal carry the sphere
    quadratic's cancellation error: the camera stands 1,700 units from the
    origin, where b^2 - a*c loses about 1e-3 of t, and XLA's CPU code
    contracts a*b+c where PyTorch rounds each operation.  So first t is
    held at the JAX package's own t tolerance (rtol 5e-5, measured
    2.6e-5), the normals within 1e-5 wherever the two t are equal and on
    at least 80% of the pixels (measured 86.7%), and within the t error
    over the radius (2e-3) everywhere."""
    scene, cam, ref = _jax_wavefront(monkeypatch, 1)
    got = [a.numpy() for a in render_radiance(scene, cam, port_sky(SKY), spp=2, max_depth=1)]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-5)
    n_err = np.abs(got[1] - ref[1]).max(-1)
    same_t = got[2] == ref[2]
    print(f"depth 1: first t equal on {same_t.mean():.4f} of the pixels, normals within 1e-5 "
          f"on {(n_err <= 1e-5).mean():.4f}, largest normal difference {n_err.max():.3e}")
    assert same_t.any() and (n_err[same_t] <= 1e-5).all()
    assert (n_err <= 1e-5).mean() >= 0.80 and n_err.max() <= 2e-3


def test_wavefront_render_matches_jax_bounced(monkeypatch):
    """Depth 3: at least 85% of the pixels within 1e-4.  A secondary ray
    starts on the surface it leaves, and the rounding of its origin decides
    whether it re-hits that surface (XLA's CPU code contracts a*b+c and has
    its own transcendentals); those pixels carry another path's radiance
    (ROADMAP.md, queue 3)."""
    scene, cam, ref = _jax_wavefront(monkeypatch, 3)
    got = render_radiance(scene, cam, port_sky(SKY), spp=2, max_depth=3)[0].numpy()
    close = np.isclose(got, ref[0], rtol=0, atol=1e-4).all(-1)
    print(f"depth 3: {close.mean():.4f} of the pixels within 1e-4")
    assert close.mean() >= 0.85, close.mean()
    assert abs(got.mean() / ref[0].mean() - 1) < 0.05


@pytest.mark.parametrize("dense", ["wavefront", "mega"])
def test_bvh_matches_dense_primary(monkeypatch, dense):
    """Depth 1 inside the port: the BVH walk's render equals the dense
    winner's bitwise (tests/test_bvh.py:200-206), on the wavefront path
    (POCA_BVH=0 POCA_MEGA=0) and on the megakernel (POCA_BVH=0)."""
    scene = presets.big_scene(220, bvh=True, device="cpu")
    cam = presets.big_camera(220, 24, 16, device="cpu")
    sky = port_sky(SKY)
    got = render_radiance(scene, cam, sky, spp=2, max_depth=1)
    monkeypatch.setenv("POCA_BVH", "0")
    if dense == "wavefront":
        monkeypatch.setenv("POCA_MEGA", "0")
    ref = render_radiance(scene, cam, sky, spp=2, max_depth=1)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_progressive_refits_stale_bvh(caplog):
    """A BVH scene whose centres were edited by a bare replace: the
    renderer warns, refits the tables and steps to a finite frame."""
    scene = presets.big_scene(96, bvh=True, device="cpu")
    moved = dataclasses.replace(scene, center=scene.center + torch.tensor([1.0, 0.0, -2.0]))
    assert moved.bvh_is_stale()
    cam = presets.big_camera(96, 12, 8, device="cpu")
    with caplog.at_level(logging.WARNING):
        r = ProgressiveRenderer(moved, cam, SKY, RenderConfig(width=12, height=8, max_depth=2))
    assert "stale" in caplog.text
    assert not r.scene.bvh_is_stale()
    assert torch.equal(r.scene.bvh_objs, moved.refit_bvh().bvh_objs)
    frame = r.step()
    assert frame.shape == (8, 12, 3) and torch.isfinite(frame).all()


def test_wavefront_gradients_flow():
    """The wavefront path is differentiable: a BVH scene whose kd requires
    grad gives a finite, nonzero kd gradient, and a no_grad render of the
    same inputs the same radiance."""
    scene = presets.big_scene(96, bvh=True, device="cpu")
    cam = presets.big_camera(96, 8, 6, device="cpu")
    kd = scene.kd.clone().requires_grad_()
    s = scene.with_material_params({"kd": kd})
    rad, _, _ = render_radiance(s, cam, port_sky(SKY), spp=1, max_depth=2)
    (g,) = torch.autograd.grad((rad * rad).sum(), kd)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    with torch.no_grad():
        rad0, _, _ = render_radiance(s, cam, port_sky(SKY), spp=1, max_depth=2)
    assert torch.equal(rad.detach(), rad0)


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_presets_match_jax(name):
    """Each preset's scene and camera equal the JAX package's."""
    jp, p = jpresets.PRESETS[name], presets.PRESETS[name]
    assert (p.width, p.height, p.spp, p.max_depth) == (jp.width, jp.height, jp.spp, jp.max_depth)
    jscene, jcam = jp.build()
    scene, cam = p.build(device="cpu")
    ref = port_scene(jscene)
    for f in dataclasses.fields(ref):
        a, b = getattr(scene, f.name), getattr(ref, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name
    ref_cam = port_camera(jcam)
    for f in ("origin", "look_at", "view_fov", "lens_radius", "move_speed", "width", "height"):
        a, b = getattr(cam, f), getattr(ref_cam, f)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f


# ------------------------------------------- the fused bounce against the body

SEED = 3_000_000_123  # above 2^31: the seed word's uint32 bits
_LIBM = ("pow", "log", "exp", "tanh", "cos", "sin", "sqrt")  # wavefront_host.cpp's tables


@pytest.fixture(scope="module")
def host_bounce(tmp_path_factory):
    """csrc/wavefront.cuh's lane body built for the host by g++
    (tests/wavefront_host.cpp)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the wavefront bounce for the host")
    lib = tmp_path_factory.mktemp("wavefront_host") / "libwavefront_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(CSRC), str(TESTS / "wavefront_host.cpp"), "-o", str(lib)], check=True,
                   timeout=120)
    so = ctypes.CDLL(str(lib))
    so.poca_wavefront_host_fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int]
    so.poca_wavefront_host_fn.restype = None
    so.poca_wavefront_host.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)
    so.poca_wavefront_host.restype = ctypes.c_int
    return so


def _recording_libm(monkeypatch):
    """Wrap the seven torch functions of wavefront_host.cpp's tables so that
    each float32 call keeps its argument (pow: the exponent) and result;
    returns the store."""
    seen = {name: [] for name in _LIBM}
    for name in _LIBM:
        def wrapped(*args, _real=getattr(torch, name), _name=name, **kw):
            out = _real(*args, **kw)
            if out.dtype == torch.float32:
                x = args[1] if _name == "pow" else args[0]
                seen[_name].append((x.detach().expand_as(out).reshape(-1).clone(),
                                    out.detach().reshape(-1).clone()))
            return out
        monkeypatch.setattr(torch, name, wrapped)
    return seen


def _libm_tables(seen):
    """Each function's (argument bits ascending, result bits) as uint32
    arrays.  An argument seen twice must have given the same result."""
    tables = []
    for name in _LIBM:
        bits = lambda k: torch.cat([p[k] for p in seen[name]]).view(torch.int32).numpy().view(
            np.uint32)
        xs, ys = bits(0), bits(1)
        keys, at = np.unique(xs, return_index=True)
        vals = ys[at]
        assert np.array_equal(vals[np.searchsorted(keys, xs)], ys), name
        tables.append((np.ascontiguousarray(keys), np.ascontiguousarray(vals)))
    return tables


def _scene_lanes(bounce: int):
    """Lanes of big_scene(96) at bounce `bounce` and each lane's winner:
    32x24 camera rays traced to that bounce by the PyTorch body (winners
    from the dense search; every fifth marked dead), two rays from the
    camera at every object with that object as its winner (every primitive
    and BSDF, emitters among them; the second ray dead), one away from
    object 0 with it as the winner (a miss), and last a ray 1e-5 above the
    platform going down (its t lies in (0, TMIN_BOUNCE]).  Returns (gs,
    planes, gidx, pix, samp)."""
    gs = fast.group_scene(presets.big_scene(96, device="cpu"))
    cam = presets.big_camera(96, 32, 24, device="cpu")
    n_cam = 32 * 24
    pix = torch.arange(n_cam, dtype=torch.int32)
    samp = (pix % 5).to(torch.int32)
    carry = (*cam.ray_gen_planar(pix, samp, SEED), None, None, None)
    zero = torch.zeros(n_cam)
    carry = (carry[0], carry[1], (zero + 1.0,) * 3, (zero,) * 3, zero < 1.0)
    tmins = (zero, zero + TMIN_BOUNCE)
    for b in range(bounce + 1):
        gidx = fast.closest_index(gs, carry[0], carry[1], tmins[b > 0], zero + INF)
        if b < bounce:
            carry, _, _ = bounce_p(gs.table_s, gs.table_r, carry, gidx, tmins[b > 0], zero + INF,
                                   pix, samp, SEED, b)
    n_obj = gs.table_s.shape[0]
    origin = cam.origin.expand(n_obj, 3)
    is_plat = gs.table_s[:, 6] == PrimitiveType.PLATFORM
    plat = int(torch.nonzero(is_plat)[0])
    centre = gs.table_s[:, 0:3].clone()
    centre[:, 1] = torch.where(is_plat, gs.table_s[:, 4] - 50.0, centre[:, 1])
    aim = (centre - origin) / (centre - origin).norm(dim=1, keepdim=True)
    above = torch.tensor([[10.0, 0.0, -20.0, 0.0, -1.0, 0.0]])
    above[0, 1] = gs.table_s[plat, 4] + 1e-5
    extra_o = torch.cat([origin, origin, origin[0:1], above[:, 0:3]])
    extra_d = torch.cat([aim, aim, -aim[0:1], above[:, 3:6]])
    n_extra = 2 * n_obj + 2
    g = torch.Generator().manual_seed(bounce)
    cat = lambda a, b: torch.cat([a, b])
    o = tuple(cat(carry[0][k], extra_o[:, k]) for k in range(3))
    d = tuple(cat(carry[1][k], extra_d[:, k]) for k in range(3))
    thru = tuple(cat(carry[2][k], torch.rand(n_extra, generator=g)) for k in range(3))
    rad = tuple(cat(carry[3][k], torch.rand(n_extra, generator=g)) for k in range(3))
    alive = cat(carry[4], torch.ones(n_extra, dtype=torch.bool))
    alive[:n_cam:5] = False
    alive[n_cam + n_obj:n_cam + 2 * n_obj] = False
    objs = torch.arange(n_obj, dtype=torch.int32)
    gidx = cat(gidx, torch.cat([objs, objs, torch.tensor([0, plat], dtype=torch.int32)]))
    r = n_cam + n_extra
    pix = torch.arange(r, dtype=torch.int32) * 7
    samp = (torch.arange(r, dtype=torch.int32) % 3) + bounce
    planes = (torch.stack([*o, *d, *thru, *rad]).contiguous(), alive,
              torch.rand((4, r), generator=g))
    return gs, planes, gidx, pix, samp


@pytest.mark.parametrize("bounce", [0, 1, 3])
def test_host_bounce_matches_body_bitwise(host_bounce, monkeypatch, bounce):
    """csrc/wavefront.cuh's lane body, built for the host, against one
    bounce of the PyTorch body (wavefront_bounce_plain) on the CPU: the
    carry, alive and first planes bitwise on every lane, at bounce 0 (tmin
    0; first written) and after (tmin TMIN_BOUNCE; first untouched).  The
    lanes cover the three primitives and four BSDFs among hits, misses,
    dead lanes that hit (they take the new ray, not the radiance), and at
    bounce 0 a hit at t in (0, TMIN_BOUNCE], which misses after.  The six
    transcendentals and sqrt answer from PyTorch's own results
    (wavefront_host.cpp: the CPU's libm and PyTorch's vectorised kernels
    round them differently), and every argument the host body gave them is
    one PyTorch saw."""
    gs, planes, gidx, pix, samp = _scene_lanes(bounce)
    ts, trt = field_major_tables(gs.table_s, gs.table_r)
    r = gidx.shape[0]
    ref = [t.clone() for t in planes]
    seen = _recording_libm(monkeypatch)
    wavefront_bounce_plain(*ref, gidx, pix, samp, SEED, ts, trt, bounce=bounce)
    monkeypatch.undo()
    tables = _libm_tables(seen)
    for k, (keys, vals) in enumerate(tables):
        host_bounce.poca_wavefront_host_fn(k, keys.ctypes.data, vals.ctypes.data, len(keys))
    got = [t.clone() for t in planes]
    missing = host_bounce.poca_wavefront_host(
        *[t.data_ptr() for t in (*got, gidx, pix, samp)], _u32_bits(SEED), ts.data_ptr(),
        trt.data_ptr(), r, ts.shape[1], bounce)
    assert missing == 0
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    # what the lanes covered
    tmin = torch.full((r,), 0.0 if bounce == 0 else TMIN_BOUNCE)
    o, d = tuple(planes[0][0:3]), tuple(planes[0][3:6])
    hit, mats = planar.gather_epilogue_p(gs.table_s, gs.table_r, o, d, tmin,
                                         torch.full((r,), INF), gidx)
    hit = hit["hit"]
    assert set(gs.table_s[gidx[hit].long(), 6].int().tolist()) == {int(p) for p in PrimitiveType}
    assert set(mats["mat_type"][hit].tolist()) == {int(m) for m in MaterialType} - {4}
    emits = (mats["emission"] > 0) & hit
    assert (~hit).any() and (emits & planes[1]).any() and (emits & ~planes[1]).any()
    dead_hit = hit & ~planes[1]
    assert torch.equal(ref[0][9:12][:, dead_hit], planes[0][9:12][:, dead_hit])
    assert not torch.equal(ref[0][0:6][:, dead_hit], planes[0][0:6][:, dead_hit])
    assert bool(hit[-1]) == (bounce == 0)
    if bounce == 0:
        assert 0.0 < float(ref[2][3, -1]) <= TMIN_BOUNCE
    if bounce > 0:
        assert torch.equal(ref[2], planes[2])


def test_fused_loop_matches_pytorch_loop():
    """trace_bounces' fused loop (integrator._trace_fused: the kernel's
    planes, one wavefront_bounce a bounce, which on CPU tensors is its plain
    version) against the PyTorch loop, trace_bounces_p, on big_scene(96)
    with its BVH at depth 4: every output bitwise, the same winners."""
    scene = presets.big_scene(96, bvh=True, device="cpu")
    cam = presets.big_camera(96, 16, 12, device="cpu")
    gs = fast.group_scene(scene)
    pix = torch.arange(16 * 12, dtype=torch.int32)
    samp = torch.full((16 * 12,), 2, dtype=torch.int32)
    rays = cam.ray_gen_planar(pix, samp, SEED)
    with torch.no_grad():
        got = integrator._trace_fused(gs, rays, pix, samp, SEED, 4)
        ref = integrator.trace_bounces_p(gs, rays, pix, samp, SEED, 4)
    flat = lambda out: [*out[0], *out[1], *out[2], out[3], *out[4], out[5], *out[6]]
    for a, b in zip(flat(got), flat(ref), strict=True):
        assert torch.equal(a, b)
    assert got[7] is None and len(ref[7]) == 4
