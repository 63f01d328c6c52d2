"""The port's CUDA kernels against their plain PyTorch versions on a card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch and the CUDA toolkit are installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import SceneBuilder, demo_scene
from cpppathtracer_tpu_torch.ops import mega
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import (
    BLOCK,
    stream_compact,
    stream_compact_plain,
    stream_expand,
    stream_expand_plain,
)
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_bwd_kernel import mega_bwd, mega_bwd_plain
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T, mega_trace, mega_trace_plain
from cpppathtracer_tpu_torch.ops.fast import group_scene
from cpppathtracer_tpu_torch.utils.rng import uniforms4

R = 1 << 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU form")
    return torch.device("cuda")


def _demo(dev):
    gs = group_scene(demo_scene(0).build(device=dev))
    cam = Camera.make(256, 256, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device=dev)
    pix = torch.arange(R, dtype=torch.int32, device=dev)
    samp = (pix % 7).to(torch.int32)
    o, d = cam.ray_gen_planar(pix, samp, 1)
    ts, trt = build_tables_T(gs)
    args = (tuple(c.contiguous() for c in o), tuple(c.contiguous() for c in d), pix, samp, 1,
            build_geom_rows(gs), ts, trt)
    return gs, args


@pytest.mark.gpu
@pytest.mark.parametrize("phase_b", [False, True], ids=["unguarded", "phase_b"])
def test_mega_trace_matches_plain_on_card(dev, phase_b):
    """Depth 8, unguarded and in the phase-B form: hit planes equal on
    >= 99.9% of lanes; on those lanes every float output within 1e-5 on
    >= 99.9% of values and within 1e-3 everywhere (both sides round each
    operation alike: the kernel is built with --fmad=false)."""
    gs, args = _demo(dev)
    kw = {}
    active = torch.ones(R, dtype=torch.bool, device=dev)
    if phase_b:
        g = torch.Generator(device=dev).manual_seed(2)
        amask = (torch.rand(R, device=dev, generator=g) < 0.2).float()
        kw = dict(start_bounce=2, thru=tuple(torch.rand(R, device=dev, generator=g) for _ in range(3)),
                  n_alive=torch.tensor([R - 5000], dtype=torch.int32, device=dev), alive_mask=amask)
        active = (torch.arange(R, device=dev) < R - 5000) & (amask == 0)
    kb.reset_launches()
    got = mega_trace(*args, counts=gs.counts, depth=8, **kw)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["mega_trace"] == 1
    ref = mega_trace_plain(*args, counts=gs.counts, depth=8, **kw)
    hg, hr = torch.stack(got[6]), torch.stack(ref[6])
    agree = (hg == hr).all(0)
    assert float(agree.float().mean()) >= 0.999
    assert bool((hg[:, ~active] == -1).all())
    flat = lambda o: torch.stack([*o[0], *o[1], *o[2], o[3], *o[4], o[5]])[:, agree]
    fg, fr = flat(got), flat(ref)
    assert float(torch.isclose(fg, fr, rtol=1e-5, atol=1e-5).float().mean()) >= 0.999
    assert torch.allclose(fg, fr, rtol=1e-3, atol=1e-3)


def _bits(t):
    return t.view(torch.int32)


def _misaligned(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out.copy_(t)
    return out


def _miss_plane(r, share, rng):
    """f32[R], 0 = alive: a random share alive, or alternating alive and
    dead runs of 1 to 3000 lanes ("runs")."""
    if share != "runs":
        return np.where(rng.uniform(size=r) < share, 0.0, 1.0).astype(np.float32)
    missed, k, alive = np.ones(r, np.float32), 0, False
    while k < r:
        run = rng.randint(1, 3000)
        missed[k:k + run] = 0.0 if alive else 1.0
        k, alive = k + run, not alive
    return missed


@pytest.mark.gpu
@pytest.mark.parametrize("share", [0.0, 0.2, 1.0, "runs"], ids=["dead", "p20", "alive", "runs"])
@pytest.mark.parametrize("r", [1, 31, BLOCK - 1, BLOCK, BLOCK + 17, 2**16 + 17, 2**22])
def test_compaction_matches_plain_on_card(dev, r, share):
    """stream_compact bitwise equal to its plain version on packed lanes
    [0, n_alive), offs and n_alive; stream_expand bitwise equal to its
    plain version with the packed tail poisoned (NaN / INT_MIN); and
    expand(compact(x)) == x on the alive lanes, the fills elsewhere.
    Float and int planes, with the miss plane and the payload 16-byte
    aligned (the kernels' vector path) and not."""
    rng = np.random.RandomState(r)
    missed = torch.from_numpy(_miss_plane(r, share, rng)).to(dev)
    x_f = torch.from_numpy(rng.normal(size=r).astype(np.float32)).to(dev)
    x_i = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, r).astype(np.int32)).to(dev)
    alive = missed == 0
    fills = [7.5, -7]
    kb.reset_launches()
    for m in (missed, _misaligned(missed)):
        for planes in ([x_f, x_i], [x_f, x_i, _misaligned(x_f)]):
            packed, offs, n_alive = stream_compact(m, planes)
            ref = stream_compact_plain(m, planes)
            n = int(n_alive[0])
            assert n == int(alive.sum())
            assert torch.equal(offs, ref[1]) and torch.equal(n_alive, ref[2])
            for a, b in zip(packed, ref[0]):
                assert a.dtype == b.dtype and torch.equal(_bits(a)[:n], _bits(b)[:n])
            for a in packed:
                _bits(a)[n:] = -2**31 if a.dtype == torch.int32 else 0x7FC00000
            got = stream_expand(m, offs, packed[:2], fills)
            want = stream_expand_plain(m, ref[1], ref[0][:2], fills)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
            assert torch.equal(got[0][alive], x_f[alive]) and torch.equal(got[1][alive], x_i[alive])
            assert bool((got[0][~alive] == 7.5).all()) and bool((got[1][~alive] == -7).all())
    torch.cuda.synchronize()
    assert kb.LAUNCHES["stream_compact"] == kb.LAUNCHES["stream_expand"] == 4
    with pytest.raises(ValueError):
        stream_compact(missed, [x_f.double()])
    with pytest.raises(ValueError):
        stream_expand(missed, offs[:-1], packed[:2], fills)


@pytest.mark.gpu
def test_uniforms4_bitwise_equal_on_card(dev):
    """The int32-wrap PCG4D draws the same bits on the card as on the CPU
    (where tests/test_torch_substrate.py holds it against the JAX package's
    NumPy form)."""
    pix = torch.from_numpy(np.random.RandomState(0).randint(-2**31, 2**31 - 1, R, dtype=np.int64))
    samp = (torch.arange(R) % 64).to(torch.int32)
    for got, ref in zip(uniforms4(2**31 - 1, pix.to(dev), samp.to(dev), 3),
                        uniforms4(2**31 - 1, pix, samp, 3)):
        assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_wrappers_check_their_arguments(dev):
    gs, args = _demo(dev)
    bad = (tuple(c[:-1] for c in args[0]),) + args[1:]
    with pytest.raises(ValueError):
        mega_trace(*bad, counts=gs.counts, depth=2)
    with pytest.raises(ValueError):
        mega_trace(*args, counts=gs.counts, depth=2, alive_mask=torch.zeros(R, device=dev))


# ------------------------------------------------------------- backward


def _bwd_inputs(dev, gs, width, depth, seed=0):
    """1024^2-style primaries of the bench camera, their winner planes from
    mega_trace, and random cotangents from a seeded generator."""
    cam = Camera.make(width, width, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0),
                      device=dev)
    r = width * width
    pix = torch.arange(r, dtype=torch.int32, device=dev)
    samp = torch.full((r,), 5, dtype=torch.int32, device=dev)
    o, d = cam.ray_gen_planar(pix, samp, seed)
    o, d = tuple(c.contiguous() for c in o), tuple(c.contiguous() for c in d)
    ts, trt = build_tables_T(gs)
    out = mega_trace(o, d, pix, samp, seed, build_geom_rows(gs), ts, trt, counts=gs.counts,
                     depth=depth, with_o=True)
    g = torch.Generator(device=dev).manual_seed(0)
    ct = [torch.randn(r, device=dev, generator=g) for _ in range(13)]
    return (o, d, pix, samp, seed, ts, trt, torch.stack(out[6]).contiguous(), ct), out


def _check_bwd(got, ref):
    """chip_smoke.py's bounds.  ct_o and ct_d: all finite, and on at least
    99.9% of the lanes each 3-vector within 1e-5 + 1e-4 x its largest
    component (float32 cancellation leaves a component much smaller than
    its lane's others no more correct digits than that, in the kernel and
    the plain version alike).  ct_ts and ct_trt: each field's row within a
    relative L2 error of 1e-4 (the kernel's atomics add in another
    order)."""
    for g, p in ((got[2], ref[2]), (got[3], ref[3])):
        g, p = torch.stack(g), torch.stack(p)
        assert torch.isfinite(g).all()
        close = (g - p).abs().amax(0) <= 1e-5 + 1e-4 * p.abs().amax(0)
        assert float(close.float().mean()) >= 0.999
    for g, p in ((got[0], ref[0]), (got[1], ref[1])):
        err = (g - p).norm(dim=1) / p.norm(dim=1).clamp(min=1e-30)
        assert float(err.max()) <= 1e-4, err


@pytest.mark.gpu
@pytest.mark.parametrize("width,depth", [(64, 1), (64, 8), (1024, 1), (1024, 8)])
def test_mega_bwd_matches_plain_on_card(dev, width, depth):
    """mega_bwd against mega_bwd_plain on the demo scene, and its rebuilt
    final carry bitwise equal to mega_trace's outputs (the two kernels
    share the bounce body)."""
    gs = group_scene(demo_scene(0).build(device=dev))
    args, out = _bwd_inputs(dev, gs, width, depth)
    kb.reset_launches()
    got = mega_bwd(*args, with_carry=True)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["mega_bwd"] == 1
    _check_bwd(got, mega_bwd_plain(*args))
    carry = got[4]
    for a, b in zip([*carry[0], *carry[1], *carry[2], carry[3]], [*out[8], *out[1], *out[2], out[3]]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_mega_bwd_global_atomics_on_card(dev):
    """A scene of 1,100 spheres pads its tables past SMEM_ACC_MAX_PAD, so
    the kernel adds the table cotangents with global atomics."""
    rng = np.random.RandomState(3)
    b = SceneBuilder()
    b.add_platform(0.0)
    for _ in range(1100):
        b.add_sphere((rng.uniform(-150, 150), rng.uniform(1, 30), rng.uniform(-550, 550)),
                     rng.uniform(1, 8), mat_type=int(rng.randint(0, 4)), smoothness=1.5,
                     reflectivity=0.5, kd=tuple(rng.uniform(0.2, 0.9, 3)))
    gs = group_scene(b.build(device=dev))
    args, _ = _bwd_inputs(dev, gs, 256, 4)
    assert args[5].shape[1] > 1024
    _check_bwd(mega_bwd(*args), mega_bwd_plain(*args))


@pytest.mark.gpu
def test_mega_sample_grads_kernel_vs_plain_on_card(dev, monkeypatch):
    """The autograd Function's gradients (kd, emission, camera origin)
    through the kernel and through the plain backward: cosine > 0.9999 and
    norms within 1e-3."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky

    scene = demo_scene(0).build(device=dev)
    sky = torch.from_numpy(procedural_sky(64, 64)).to(dev)

    def grads():
        kd = scene.kd.clone().requires_grad_()
        em = scene.emission.clone().requires_grad_()
        cam = Camera.make(256, 256, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0),
                          device=dev)
        origin = cam.origin.clone().requires_grad_()
        s = scene.with_material_params({"kd": kd, "emission": em})
        rad, _, _ = render_radiance(s, cam.replace(origin=origin), sky, spp=2, max_depth=8)
        return torch.autograd.grad((rad * rad).sum(), (kd, em, origin))

    kb.reset_launches()
    k = grads()
    assert kb.LAUNCHES["mega_bwd"] == 2
    monkeypatch.setattr(mega, "mega_bwd", mega_bwd_plain)
    p = grads()
    for a, b in zip(k, p):
        a, b = a.flatten().double(), b.flatten().double()
        assert float(a @ b / (a.norm() * b.norm())) > 0.9999
        assert abs(float(a.norm() / b.norm()) - 1) < 1e-3


# ------------------------------------------------- the wavefront path's winners


def _primaries(dev, n, width):
    """width^2 primaries of big_camera(n), sample 3, as planar rays with
    tmin 0 and tmax INF."""
    from cpppathtracer_tpu_torch.models.presets import big_camera
    from cpppathtracer_tpu_torch.types import INF

    cam = big_camera(n, width, width, device=dev)
    r = width * width
    pix = torch.arange(r, dtype=torch.int32, device=dev)
    o, d = cam.ray_gen_planar(pix, torch.full((r,), 3, dtype=torch.int32, device=dev), 0)
    flat = lambda v: tuple(c.contiguous() for c in v)
    return flat(o), flat(d), torch.zeros(r, device=dev), torch.full((r,), INF, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("leaf_size", [None, 8], ids=["auto", "leaf8"])
def test_bvh_winner_index_matches_plain_on_card(dev, leaf_size):
    """The BVH walk kernel equals its plain version bitwise on 2^16
    primaries of big_scene(4096), with the automatic leaf size (K = 32) and
    with K = 8 (about 1,000 nodes)."""
    from cpppathtracer_tpu_torch.models.presets import big_scene
    from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import bvh_winner_index, bvh_winner_index_plain

    scene = big_scene(4096, bvh=False, device=dev).with_bvh(leaf_size)
    ray = _primaries(dev, 4096, 256)
    tables = (scene.bvh_meta, scene.bvh_aabb, scene.bvh_objs)
    k = scene.bvh_dims[1]
    kb.reset_launches()
    got = bvh_winner_index(*ray, *tables, leaf_size=k)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["bvh_winner_index"] == 1
    ref = bvh_winner_index_plain(*ray, *tables, leaf_size=k)
    assert torch.equal(got, ref)
    assert float((got > 0).float().mean()) > 0.25


@pytest.mark.gpu
def test_winner_index_matches_plain_on_card(dev):
    """The standalone dense winner kernel equals its plain version bitwise
    on 2^16 primaries of big_scene(2048)."""
    from cpppathtracer_tpu_torch.models.presets import big_scene
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import winner_index, winner_index_plain

    gs = group_scene(big_scene(2048, bvh=False, device=dev))
    ray = _primaries(dev, 2048, 256)
    geom = build_geom_rows(gs)
    kb.reset_launches()
    got = winner_index(gs.counts, *ray, geom)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["winner_index"] == 1
    assert torch.equal(got, winner_index_plain(gs.counts, *ray, geom))


@pytest.mark.gpu
def test_winner_index_refuses_rows_beyond_shared_memory(dev):
    """A scene whose geometry rows exceed one block's shared memory raises
    a ValueError that names the limit, and launches nothing."""
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import WINNER_SMEM_MAX, winner_index

    n = WINNER_SMEM_MAX // 32 + 8
    ray = _primaries(dev, 1024, 16)
    kb.reset_launches()
    with pytest.raises(ValueError, match=str(WINNER_SMEM_MAX)):
        winner_index((n, 0, 0), *ray, torch.zeros((n, 8), device=dev))
    assert kb.LAUNCHES["winner_index"] == 0
