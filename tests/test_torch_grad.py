"""The port's training path on the CPU: the score-function weight and
shade_p's gradients, the replay's gradients (mega_bwd_plain) and the
backward kernel's per-ray body compiled for the host, end-to-end
gradients of render_radiance, finite differences on the independent
oracle (reference_cpu), and the serving path's no-grad rule.
(tests/test_torch_inverse.py holds inverse.fit.)

The JAX side runs as the JAX package's own tests run it on the CPU.  For
end-to-end gradients that is its default bounce-loop path, which
tests/test_mega.py holds to its megakernel path at the tolerances used
here; the megakernel's interpret mode takes about a minute per gradient on
this CPU.  Inputs come from numpy seeds.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu import reference_cpu as oracle
from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops import bsdf as j_bsdf
from cpppathtracer_tpu.ops import fast as j_fast
from cpppathtracer_tpu.ops import planar as j_planar
from cpppathtracer_tpu.ops.mega import _replay_chain as j_replay_chain
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.ops import bsdf, planar
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd, mega_bwd_plain
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T, mega_trace_plain
from cpppathtracer_tpu_torch.ops.fast import group_scene
from cpppathtracer_tpu_torch.renderer import AccumulatorState, frame_step

from test_grad_oracle import DEPTH as O_DEPTH
from test_grad_oracle import SEED as O_SEED
from test_grad_oracle import SKY as O_SKY
from test_grad_oracle import SPP as O_SPP
from test_grad_oracle import W_RGB, _cam as oracle_cam, _scene as oracle_scene
from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "cpppathtracer_tpu_torch" / "csrc"
FIELDS = ("kd", "emission", "smoothness", "reflectivity", "ior")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ (a) shading


def _shade_inputs(seed, r=4096):
    """Random shading inputs of every material type; a few normals are
    zero, as on a lane whose recomputed hit missed."""
    rng = np.random.RandomState(seed)
    unit = lambda: (lambda v: v / np.linalg.norm(v, axis=0))(rng.normal(size=(3, r)))
    normal = unit()
    normal[:, :16] = 0.0
    f = lambda a: np.asarray(a, np.float32)
    u = lambda: (rng.randint(0, 2**24, r) * 2.0**-24).astype(np.float32)
    return dict(
        normal=f(normal), in_dir=f(unit()), mat_type=rng.randint(0, 5, r).astype(np.int32),
        kd=f(rng.uniform(0, 1, (3, r))), emission=f(rng.uniform(0, 2, r)),
        smoothness=f(rng.uniform(0, 5, r)), reflectivity=f(rng.uniform(0, 1, r)),
        ior=f(rng.uniform(1.05, 2.5, r)), u1=u(), u2=u(), u3=u(),
    )


def test_score_weight_matches_jax():
    """The weight is exactly 1.0 in value; its gradient w.r.t. both
    probabilities matches jax.vjp within 1e-6, including p = 0 and p = 1
    (the double-where guard)."""
    rng = np.random.RandomState(0)
    r = 4096
    p = rng.uniform(0, 1, r).astype(np.float32)
    q = rng.uniform(0, 1, r).astype(np.float32)
    p[:8], q[8:16] = 0.0, 1.0
    u3 = rng.uniform(0, 1, r).astype(np.float32)
    is_mirror = rng.uniform(size=r) < 0.5
    is_glass = rng.uniform(size=r) < 0.5
    ct = rng.normal(size=r).astype(np.float32)
    args = lambda conv, pp, qq: (conv(is_mirror), conv(u3) < pp, pp, conv(is_glass), conv(u3) < qq, qq)

    w_j, vjp = jax.vjp(lambda a, b: j_bsdf._score_weight(*args(jnp.asarray, a, b)),
                       jnp.asarray(p), jnp.asarray(q))
    gp_j, gq_j = vjp(jnp.asarray(ct))
    pt, qt = _t(p).requires_grad_(), _t(q).requires_grad_()
    w = bsdf._score_weight(*args(_t, pt, qt))
    assert (w.detach() == 1.0).all() and (np.asarray(w_j) == 1.0).all()
    gp, gq = torch.autograd.grad(w, (pt, qt), _t(ct))
    np.testing.assert_allclose(gp.numpy(), np.asarray(gp_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gq.numpy(), np.asarray(gq_j), rtol=1e-6, atol=1e-6)


def test_shade_with_score_matches_jax():
    """shade_p(with_score=True): values within 1e-6, the weight exactly
    1.0, and the vjp w.r.t. normal, in_dir and the five material fields
    within 1e-6, on 4096 random lanes of every material type."""
    x = _shade_inputs(1)
    diff = ("normal", "in_dir", "kd", "emission", "smoothness", "reflectivity", "ior")
    r = x["u1"].shape[0]
    cts = np.random.RandomState(2).normal(size=(9, r)).astype(np.float32)

    def shade(shade_p, conv, *vals):
        v = dict(zip(diff, vals))
        mats = {"mat_type": conv(x["mat_type"]), "kd_p": tuple(v["kd"]),
                "emission": v["emission"], "smoothness": v["smoothness"],
                "reflectivity": v["reflectivity"], "ior": v["ior"]}
        b, a, e, w = shade_p(mats, tuple(v["normal"]), tuple(v["in_dir"]), conv(x["u1"]),
                             conv(x["u2"]), conv(x["u3"]), with_score=True)
        return [*b, *a, *e], w

    def j_fn(*vals):
        out, w = shade(j_planar.shade_p, jnp.asarray, *vals)
        return jnp.stack(out), w

    (out_j, w_j), vjp = jax.vjp(j_fn, *[jnp.asarray(x[k]) for k in diff])
    grads_j = vjp((jnp.asarray(cts), jnp.zeros(r, jnp.float32)))
    leaves = [_t(x[k]).requires_grad_() for k in diff]
    out, w = shade(planar.shade_p, _t, *leaves)
    out = torch.stack(out)
    assert (w.detach() == 1.0).all() and (np.asarray(w_j) == 1.0).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)
    grads = torch.autograd.grad(out, leaves, _t(cts))
    for name, g, g_j in zip(diff, grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-6, err_msg=name)


# -------------------------------------------------------------- (b) replay


def _sample_setup(jscene, origin, look_at, w, h, depth, seed=7):
    """Primary rays, tables and the port's winner planes for one sample."""
    cam = port_camera(JCamera.make(w, h, origin=origin, look_at=look_at))
    r = w * h
    pix = torch.arange(r, dtype=torch.int32)
    samp = (pix % 5).to(torch.int32)
    o, d = cam.ray_gen_planar(pix, samp, seed)
    gs = group_scene(port_scene(jscene))
    ts, trt = build_tables_T(gs)
    out = mega_trace_plain(o, d, pix, samp, seed, build_geom_rows(gs), ts, trt,
                           counts=gs.counts, depth=depth, with_o=True)
    return dict(o=o, d=d, pix=pix, samp=samp, seed=seed, gs=gs, ts=ts, trt=trt,
                hits=torch.stack(out[6]).contiguous(), out=out)


def _rehits(s, near=0.05):
    """Lanes whose secondary ray hits the object it leaves within `near`:
    the demo scene's coordinates (up to 550) round a secondary origin by
    more than BOUNCE_RAY_TMIN, so some 9% of its paths re-hit their own
    surface at a t that is the quadratic's cancellation error
    (tests/test_torch_kernels.py)."""
    depth = s["hits"].shape[0]
    r = s["pix"].shape[0]
    geom = build_geom_rows(s["gs"])
    found = torch.zeros(r, dtype=torch.bool)
    for b in range(1, depth):
        nxt = mega_trace_plain(s["o"], s["d"], s["pix"], s["samp"], s["seed"], geom, s["ts"],
                               s["trt"], counts=s["gs"].counts, depth=b, with_o=True)
        enc = s["hits"][b]
        hitrec, _ = planar.gather_epilogue_p(s["ts"].T, s["trt"].T, nxt[8], nxt[1],
                                             torch.full((r,), 2e-5), torch.full((r,), 1e30),
                                             torch.clamp(enc, min=0))
        found |= (enc >= 0) & (enc == s["hits"][b - 1]) & (hitrec["t"] < near)
    return found


@pytest.mark.parametrize("which", ["controlled", "demo"])
def test_replay_grads_match_jax_replay(which):
    """mega_bwd_plain against jax.vjp of the JAX package's replay chain on
    the same saved winner planes and random cotangents: rtol 1e-4,
    atol 1e-5, as tests/test_mega.py holds the Pallas backward to the
    replay (for ct_o and ct_d, of each lane's vector: `_lane_close`).
    On the demo scene a lane whose secondary ray re-hits the
    surface it leaves (`_rehits`) differentiates a t that is all
    cancellation error, so the two packages' roundings can give different
    gradients there; those lanes (at most 12%) get zero cotangents on both
    sides.  A long path multiplies the Jacobians of its bounces (t / r up
    to ~30 each), which amplifies the two packages' different float32
    rounding of the forward to ~1e-3 on a few lanes (mirror, glass, mirror
    at t = 371, 92, 90 for one), so on the demo scene 99.5% of the lanes
    hold it, and over the lanes that do, each table column (a sum over
    lanes) holds a relative L2 error of 1e-4."""
    if which == "controlled":
        s = _sample_setup(controlled_scene(), (0.0, 4.0, -14.0), (0.0, 1.5, 0.0), 16, 12, 3)
        keep = torch.ones(s["pix"].shape[0], dtype=torch.bool)
    else:
        s = _sample_setup(j_demo_scene(seed=0).build(), (130.0, 103.0, 130.0),
                          (0.0, 0.0, 0.0), 32, 24, 3)
        keep = ~_rehits(s)
        assert keep.float().mean() >= 0.88
    r = s["pix"].shape[0]
    ct = np.random.RandomState(0).normal(size=(13, r)).astype(np.float32)

    jscene = controlled_scene() if which == "controlled" else j_demo_scene(seed=0).build()
    jgs = j_fast.group_scene(jscene)
    hits_j = tuple(jnp.asarray(h.numpy()) for h in s["hits"])

    def replay(o, d, tables):
        gs_ = dataclasses.replace(jgs, table_s=tables[0], table_r=tables[1])
        z = o[0] * 0.0
        one = z + 1.0
        _, d2, thru, rad, _, fn, ft, _ = j_replay_chain(
            gs_, o, d, (one, one, one), (z, z, z), z < 1.0, hits_j,
            jnp.asarray(s["pix"].numpy()), jnp.asarray(s["samp"].numpy()), s["seed"], 0, False,
        )
        return rad, d2, thru, fn, ft

    jv = lambda v: tuple(jnp.asarray(c.numpy()) for c in v)
    _, vjp = jax.vjp(replay, jv(s["o"]), jv(s["d"]), (jgs.table_s, jgs.table_r))

    def both(keep):
        c = ct * keep.numpy()
        got = mega_bwd_plain(s["o"], s["d"], s["pix"], s["samp"], s["seed"], s["ts"], s["trt"],
                             s["hits"], list(_t(c)))
        c = [jnp.asarray(x) for x in c]
        ref = vjp((tuple(c[0:3]), tuple(c[3:6]), tuple(c[6:9]), tuple(c[9:12]), c[12]))
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
        else:  # each column, a sum over lanes, within relative L2 1e-4
            err = np.linalg.norm(g - g_j, axis=0) / np.maximum(np.linalg.norm(g_j, axis=0), 1e-30)
            assert err.max() <= 1e-4, err


def test_mega_bwd_wrapper_takes_plain_on_cpu():
    s = _sample_setup(controlled_scene(), (0.0, 4.0, -14.0), (0.0, 1.5, 0.0), 8, 6, 2)
    ct = list(_t(np.random.RandomState(1).normal(size=(13, 48)).astype(np.float32)))
    kb.reset_launches()
    args = (s["o"], s["d"], s["pix"], s["samp"], s["seed"], s["ts"], s["trt"], s["hits"], ct)
    a = mega_bwd(*args, with_carry=True)
    b = mega_bwd_plain(*args)
    assert kb.LAUNCHES["mega_bwd"] == 0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the rebuilt final carry is the forward's
    out = s["out"]
    for x, y in zip([*a[4][0], *a[4][1], *a[4][2], a[4][3]], [*out[8], *out[1], *out[2], out[3]]):
        assert torch.equal(x, y)


# ------------------------------------------- the kernel's body on the host


@pytest.fixture(scope="module")
def host_bwd(tmp_path_factory):
    """csrc/mega_bwd.cuh's per-ray body built for the host by g++
    (tests/mega_bwd_host.cpp)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the backward kernel's body for the host")
    lib = tmp_path_factory.mktemp("mega_bwd_host") / "libmega_bwd_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(CSRC),
                    str(TESTS / "mega_bwd_host.cpp"), "-o", str(lib)], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.poca_mega_bwd_host.argtypes = [ctypes.c_void_p] * 27 + [ctypes.c_int] * 4
    so.poca_mega_bwd_host.restype = ctypes.c_int

    def run(o, d, pix, samp, seed, ts, trt, hits, ct):
        r, n_pad = pix.shape[0], ts.shape[1]
        tab, od, carry = torch.zeros(17, n_pad), torch.zeros(6, r), torch.zeros(10, r)
        ptrs = [t.data_ptr() for t in (*o, *d, pix, samp, ts, trt, hits, *ct, tab, od, carry)]
        assert so.poca_mega_bwd_host(*ptrs, r, n_pad, hits.shape[0], seed) == 0
        return tab[:13], tab[13:], od[:3], od[3:], carry

    return run


def _lane_close(got, ref, rtol=1e-4, atol=1e-5):
    """Per lane, the 3-vector within atol + rtol * its largest component:
    a component much smaller than its lane's others holds only what the
    cancellation leaves of float32 precision."""
    scale = ref.abs().amax(0)
    return ((got - ref).abs().amax(0) <= atol + rtol * scale)


@pytest.mark.parametrize("which", ["controlled", "demo"])
def test_mega_bwd_body_on_host_matches_plain(host_bwd, which):
    """The kernel's hand-derived adjoints, compiled for the host, against
    torch autograd of the replay (mega_bwd_plain) on the same winner
    planes and cotangents.  The host's libm rounds exp/log/tanh/sin/cos/
    pow unlike PyTorch's, so on the demo scene a few lanes' rebuilt carries
    part (a re-hit whose t is cancellation error); those lanes (at most
    0.5%) get zero cotangents.  Then: each of ct_o and ct_d within rtol
    1e-4 of its lane's scale on at least 99.5% of lanes, and the table
    cotangents within relative L2 1e-5 (controlled) / 1e-4 (demo)."""
    if which == "controlled":
        s = _sample_setup(controlled_scene(), (0.0, 4.0, -14.0), (0.0, 1.5, 0.0), 24, 16, 5)
    else:
        s = _sample_setup(j_demo_scene(seed=0).build(), (40.0, 25.0, 40.0), (0.0, 0.0, 0.0),
                          48, 32, 6, seed=2)
    r = s["pix"].shape[0]
    args = (s["o"], s["d"], s["pix"], s["samp"], s["seed"], s["ts"], s["trt"], s["hits"])
    ct = _t(np.random.RandomState(3).normal(size=(13, r)).astype(np.float32))
    carry = host_bwd(*args, list(ct))[4]
    out = s["out"]
    fwd = torch.stack([*out[8], *out[1], *out[2], out[3]])
    parted = ((carry - fwd).abs() > 1e-4 * (1.0 + fwd.abs())).any(0)
    assert parted.float().mean() <= (0.0 if which == "controlled" else 0.005)
    ct = torch.where(parted, 0.0, ct)
    got = host_bwd(*args, list(ct))
    ref = mega_bwd_plain(*args, list(ct))
    for g, p in ((got[2], torch.stack(ref[2])), (got[3], torch.stack(ref[3]))):
        assert torch.isfinite(g).all()
        assert _lane_close(g, p).float().mean() >= 0.995
    bound = 1e-5 if which == "controlled" else 1e-4
    for g, p in ((got[0], ref[0]), (got[1], ref[1])):
        assert float((g - p).norm() / p.norm()) <= bound


# ------------------------------------------------------ (c), (e) end to end


def _port_grads(jscene, jcam, sky, spp, depth, fields, mask=None, sky_origin=False):
    scene, cam, tsky = port_scene(jscene), port_camera(jcam), port_sky(sky)
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in fields}
    if sky_origin:
        leaves["sky"] = tsky.clone().requires_grad_()
        leaves["origin"] = cam.origin.clone().requires_grad_()
        tsky, cam = leaves["sky"], cam.replace(origin=leaves["origin"])
    scene = scene.with_material_params({k: leaves[k] for k in fields})
    rad, _, _ = render_radiance(scene, cam, tsky, spp=spp, max_depth=depth, seed=0)
    if mask is not None:
        rad = rad * _t(mask)[:, None]
    grads = torch.autograd.grad((rad * rad).sum(), list(leaves.values()), allow_unused=True)
    return {k: (torch.zeros_like(v) if g is None else g).numpy() for (k, v), g in zip(leaves.items(), grads)}


def _jax_grads(jscene, jcam, sky, spp, depth, fields, mask=None, sky_origin=False):
    m = 1.0 if mask is None else jnp.asarray(mask)[:, None]

    def loss(p, sky_t, origin):
        s = jscene.with_material_params({**jscene.material_params(), **p})
        rad, _, _ = j_render_radiance(s, jcam.replace(origin=origin), sky_t, spp=spp,
                                      max_depth=depth, seed=0)
        rad = rad * m
        return jnp.sum(rad * rad)

    p0 = {k: jscene.material_params()[k] for k in fields}
    g, g_sky, g_o = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(p0, jnp.asarray(sky), jcam.origin)
    out = {k: np.asarray(v) for k, v in g.items()}
    if sky_origin:
        out["sky"], out["origin"] = np.asarray(g_sky), np.asarray(g_o)
    return out


def _agreeing_pixels(jscene, jcam, sky, spp, depth):
    """1.0 where the port's radiance equals the JAX package's within 1e-5."""
    with torch.no_grad():
        rad = render_radiance(port_scene(jscene), port_camera(jcam), port_sky(sky), spp=spp,
                              max_depth=depth, seed=0)[0].numpy()
    rad_j = np.asarray(j_render_radiance(jscene, jcam, jnp.asarray(sky), spp=spp,
                                         max_depth=depth, seed=0)[0])
    return (np.abs(rad - rad_j).max(-1) <= 1e-5).astype(np.float32)


def test_render_grads_match_jax_controlled():
    """12x8, 2 spp, depth 3 (tests/test_mega.py's size): every material
    field, the sky and the camera origin.  A few paths per hundred take
    another turn in XLA's arithmetic than in PyTorch's (see
    tests/test_torch_render.py); a pixel holding one carries a whole
    path's gradient, so the loss keeps only the pixels whose radiance
    agrees within 1e-5 (at least 90%).  Then materials and sky within
    rtol 1e-3, atol 1e-3, the origin within 1e-2 (test_mega.py's bounds)."""
    jscene = controlled_scene()
    jcam = JCamera.make(12, 8, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))
    sky = procedural_sky(16, 16)
    mask = _agreeing_pixels(jscene, jcam, sky, 2, 3)
    assert mask.mean() >= 0.9, mask.mean()
    got = _port_grads(jscene, jcam, sky, 2, 3, FIELDS, mask, sky_origin=True)
    ref = _jax_grads(jscene, jcam, sky, 2, 3, FIELDS, mask, sky_origin=True)
    assert np.abs(ref["sky"]).max() > 0 and np.abs(ref["kd"]).max() > 0
    for k in FIELDS + ("sky",):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(got["origin"], ref["origin"], rtol=1e-2, atol=1e-2)


def test_render_grads_match_jax_demo():
    """demo_scene(0), 8x6, 1 spp, depth 3 (test_mega.py's aggregate test):
    kd and emission gradients with cosine > 0.999 and norms within 5e-3,
    on the pixels whose radiance agrees within 1e-5 (as in the controlled
    test; at least 80% of them)."""
    jscene = j_demo_scene(seed=0).build()
    jcam = JCamera.make(8, 6, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
    sky = procedural_sky(16, 16)
    mask = _agreeing_pixels(jscene, jcam, sky, 1, 3)
    assert mask.mean() >= 0.8, mask.mean()
    got = _port_grads(jscene, jcam, sky, 1, 3, ("kd", "emission"), mask)
    ref = _jax_grads(jscene, jcam, sky, 1, 3, ("kd", "emission"), mask)
    for k in ("kd", "emission"):
        a, b = ref[k].ravel(), got[k].ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
        assert cos > 0.999, (k, cos)
        assert abs(np.linalg.norm(b) / np.linalg.norm(a) - 1) < 5e-3, k


def test_render_grads_finite_on_demo_depth3():
    """Every material field, the sky, the camera origin and look-at: finite
    gradients on the demo scene at depth 3, and nonzero for kd, emission,
    the sky and the origin."""
    scene = port_scene(j_demo_scene(seed=0).build())
    cam = port_camera(JCamera.make(16, 12, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0)))
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in FIELDS}
    leaves["sky"] = port_sky(procedural_sky(16, 16)).requires_grad_()
    leaves["origin"] = cam.origin.clone().requires_grad_()
    leaves["look_at"] = cam.look_at.clone().requires_grad_()
    cam = cam.replace(origin=leaves["origin"], look_at=leaves["look_at"])
    scene = scene.with_material_params({k: leaves[k] for k in FIELDS})
    rad, n0, t0 = render_radiance(scene, cam, leaves["sky"], spp=2, max_depth=3, seed=1)
    loss = (rad * rad).sum() + 0.1 * n0.sum() + 1e-3 * torch.where(t0 < 1e29, t0, 0.0).sum()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
    for k in ("kd", "emission", "sky", "origin"):
        assert grads[k].abs().max() > 0, k


# --------------------------------------------------------- (d) the oracle


def _oracle_setup():
    """tests/test_grad_oracle.py's probe scene, camera and sky; the loss
    keeps the pixels whose port radiance equals the oracle's within 1e-5
    (the rest are re-hit flips that the two implementations round apart)."""
    jscene = oracle_scene()
    sky = np.asarray(O_SKY)
    scene, cam = port_scene(jscene), port_camera(oracle_cam())
    rad_o, _, _ = oracle.render_image_np(jscene, oracle_cam(), sky, O_SPP, O_DEPTH, seed=O_SEED)
    with torch.no_grad():
        rad = render_radiance(scene, cam, port_sky(sky), spp=O_SPP, max_depth=O_DEPTH,
                              seed=O_SEED)[0].numpy().reshape(rad_o.shape)
    mask = (np.abs(rad - rad_o).max(-1) <= 1e-5).astype(np.float32)
    assert mask.mean() >= 0.9, mask.mean()
    return jscene, sky, scene, cam, mask


def _oracle_loss(jscene, sky, mask):
    rad, _, _ = oracle.render_image_np(jscene, oracle_cam(), sky, O_SPP, O_DEPTH, seed=O_SEED)
    rad = np.asarray(rad, np.float64) * mask[..., None]
    return float(np.sum(rad * W_RGB) / mask.size)


def test_grads_match_oracle_fd():
    """tests/test_grad_oracle.py's checks on the port's gradients: kd
    (three entries), emission and the sky's largest entry within 1e-4 of
    central differences on the oracle, smoothness within 1e-3."""
    jscene, sky, scene, cam, mask = _oracle_setup()
    w_rgb = torch.tensor(W_RGB, dtype=torch.float32)
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in ("kd", "emission", "smoothness")}
    leaves["sky"] = port_sky(sky).requires_grad_()
    s = scene.with_material_params({k: leaves[k] for k in ("kd", "emission", "smoothness")})
    rad, _, _ = render_radiance(s, cam, leaves["sky"], spp=O_SPP, max_depth=O_DEPTH, seed=O_SEED)
    loss = (rad * _t(mask).reshape(-1, 1) * w_rgb).sum() / mask.size
    g = {k: v.numpy().astype(np.float64)
         for k, v in zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}

    def fd(field, index, eps, rel):
        def at(e):
            if field == "sky":
                s2 = sky.copy()
                s2[index] += e
                return _oracle_loss(jscene, s2, mask)
            a = np.asarray(getattr(jscene, field)).copy()
            a[index] += e
            return _oracle_loss(dataclasses.replace(jscene, **{field: jnp.asarray(a)}), sky, mask)

        want = (at(eps) - at(-eps)) / (2 * eps)
        got = g[field][index]
        assert abs(want - got) <= rel * max(1.0, abs(want), abs(got)), (field, index, want, got)

    for index in [(0, 0), (1, 1), (1, 2)]:
        fd("kd", index, 2e-3, 1e-4)
    fd("emission", 1, 2e-3, 1e-4)
    flat = np.abs(g["sky"]).sum(-1)
    iy, ix = np.unravel_index(np.argmax(flat), flat.shape)
    fd("sky", (iy, ix, int(np.argmax(np.abs(g["sky"][iy, ix])))), 5e-3, 1e-4)
    fd("smoothness", 2, 5e-3, 1e-3)


# ------------------------------------------------------ (g) serving path


def test_serving_path_builds_no_graph():
    """frame_step runs under no_grad: a scene and sky that require grad
    give a frame that does not."""
    scene = port_scene(controlled_scene())
    scene = scene.with_material_params({"kd": scene.kd.clone().requires_grad_()})
    cam = port_camera(JCamera.make(12, 8, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0)))
    sky = port_sky(procedural_sky(8, 8)).requires_grad_()
    state, img = frame_step(scene, cam, sky, AccumulatorState.create(8, 12, "cpu"), 0, 2, True)
    assert not img.requires_grad and not state.mix.requires_grad
    rad, _, _ = render_radiance(scene, cam, sky, spp=1, max_depth=2)
    assert rad.requires_grad
