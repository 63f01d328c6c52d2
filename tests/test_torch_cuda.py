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
from cpppathtracer_tpu_torch.ops import fast, mega
from cpppathtracer_tpu_torch.ops.cuda import bvh_kernel
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
from cpppathtracer_tpu_torch.types import INF, MaterialType
from cpppathtracer_tpu_torch.utils.rng import uniforms4

from torch_scenes import tie_rays, tie_scene

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


@pytest.mark.gpu
@pytest.mark.parametrize("alive", [None, 0.0, 0.2, 1.0], ids=["unguarded", "b0", "b20", "b100"])
@pytest.mark.parametrize("r", [1000, R])
def test_mega_trace_aux_matches_plain_on_card(dev, r, alive):
    """The with_aux form (textured scenes), depth 8, on r demo primaries:
    unguarded, or in the phase-B form with n_alive = r - 100 and a share
    `alive` of the lanes unmasked.  Every output, the 4 x 8 aux planes
    included, bitwise equal to the plain version's; its other outputs
    bitwise equal to the form without aux; inactive lanes' aux planes 0."""
    gs, args = _demo(dev)
    cut = lambda v: tuple(c[:r].contiguous() for c in v)
    args = (cut(args[0]), cut(args[1]), args[2][:r].contiguous(), args[3][:r].contiguous(),
            *args[4:])
    kw = {}
    active = torch.ones(r, dtype=torch.bool, device=dev)
    if alive is not None:
        g = torch.Generator(device=dev).manual_seed(3)
        amask = (torch.rand(r, device=dev, generator=g) >= alive).float()
        kw = dict(start_bounce=2, thru=tuple(torch.rand(r, device=dev, generator=g) for _ in range(3)),
                  n_alive=torch.tensor([r - 100], dtype=torch.int32, device=dev), alive_mask=amask)
        active = (torch.arange(r, device=dev) < r - 100) & (amask == 0)
    kb.reset_launches()
    got = mega_trace(*args, counts=gs.counts, depth=8, with_aux=True, **kw)
    plain_form = mega_trace(*args, counts=gs.counts, depth=8, **kw)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["mega_trace"] == kb.LAUNCHES["mega_trace_aux"] == 1
    ref = mega_trace_plain(*args, counts=gs.counts, depth=8, with_aux=True, **kw)
    flat = lambda o: [*o[0], *o[1], *o[2], o[3], *o[4], o[5], *o[6]]
    aux = lambda o: [c for pos, att in o[7] for c in (*pos, att)]
    assert len(aux(got)) == 32 and plain_form[7] is None
    for a, b in zip(flat(got) + aux(got), flat(ref) + aux(ref)):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(flat(got), flat(plain_form)):
        assert torch.equal(_bits(a), _bits(b))
    for c in aux(got):
        assert bool((c[~active] == 0).all())


def _planes(out):
    """Every plane of a trace: the 14 floats, the hit planes, the aux planes
    (with_aux) and the final origin (with_o)."""
    planes = [*out[0], *out[1], *out[2], out[3], *out[4], out[5], *out[6]]
    planes += [c for pos, att in out[7] or () for c in (*pos, att)]
    return planes + (list(out[8]) if len(out) > 8 else [])


def _same_bits(got, ref):
    return len(got) == len(ref) and all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("with_aux", [False, True], ids=["plain_form", "aux"])
@pytest.mark.parametrize("n_alive", [0, 1, 31, 33, R])
def test_mega_trace_early_exit_matches_plain_on_card(dev, n_alive, with_aux):
    """The kernel as it is (blocks of 128 lanes whose warps take rays from
    a counter, a path ending at its first miss), depth 8 from bounce 0, on
    2^16 demo primaries (every fourth turned up to the sky) with a random
    input throughput, 10% of the lanes masked and n_alive in
    {0, 1, 31, 33, R} (a counter that stops inside the first warp, at a
    warp's edge, past it, at R): every plane, the final origin and the aux
    planes included, bitwise equal to the plain version's.  At
    n_alive = R, paths end at every one of the 8 bounces, and some lanes
    that ended early carry nonzero aux planes at a later bounce (pos = the
    ray's origin)."""
    gs, args = _demo(dev)
    up = args[2] % 4 == 0
    d = (args[1][0], torch.where(up, args[1][1].abs(), args[1][1]), args[1][2])
    args = (args[0], d, *args[2:])
    g = torch.Generator(device=dev).manual_seed(4)
    kw = dict(counts=gs.counts, depth=8, with_o=True, with_aux=with_aux,
              thru=tuple(torch.rand(R, device=dev, generator=g) for _ in range(3)),
              n_alive=torch.tensor([n_alive], dtype=torch.int32, device=dev),
              alive_mask=(torch.rand(R, device=dev, generator=g) < 0.1).float())
    kb.reset_launches()
    got = mega_trace(*args, **kw)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["mega_trace_aux" if with_aux else "mega_trace"] == 1
    ref = mega_trace_plain(*args, **kw)
    assert _same_bits(_planes(got), _planes(ref))
    if n_alive == R:
        hits = torch.stack(ref[6])
        missed = hits < 0
        first = torch.where(missed.any(0), missed.int().argmax(0), 8)
        live = (torch.arange(R, device=dev) < n_alive) & (kw["alive_mask"] == 0)
        assert all(bool(((first == b) & live).any()) for b in range(8))
        if with_aux:
            late = torch.stack([ref[7][7][0][k] for k in range(3)]).abs().amax(0)
            assert bool(((first < 7) & live & (late > 0)).any())


@pytest.mark.gpu
def test_kernels_reset_their_counters_on_card(dev):
    """mega_trace zeroes its ray counter on the stream before each launch:
    both forms called twice in a row on one stream, on other inputs the
    second time, each equal to its plain version bitwise; winner_index the
    same way."""
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import winner_index, winner_index_plain

    gs, args = _demo(dev)
    flip = lambda v: tuple(c.flip(0).contiguous() for c in v)
    args2 = (flip(args[0]), flip(args[1]), args[2].flip(0).contiguous(), args[3], *args[4:])
    for with_aux in (False, True):
        kw = dict(counts=gs.counts, depth=4, with_aux=with_aux)
        first, second = mega_trace(*args, **kw), mega_trace(*args2, **kw)
        assert _same_bits(_planes(first), _planes(mega_trace_plain(*args, **kw)))
        assert _same_bits(_planes(second), _planes(mega_trace_plain(*args2, **kw)))
    geom = build_geom_rows(gs)
    tmin, tmax = torch.zeros(R, device=dev), torch.full((R,), INF, device=dev)
    for o, d in ((args[0], args[1]), (args2[0], args2[1])):
        assert torch.equal(winner_index(gs.counts, o, d, tmin, tmax, geom),
                           winner_index_plain(gs.counts, o, d, tmin, tmax, geom))


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


def _bwd_inputs(dev, gs, width, depth, seed=0, origin=(130.0, 103.0, 130.0)):
    """1024^2-style primaries of the bench camera (or one at `origin`
    looking at the origin), their winner planes from mega_trace, and
    random cotangents from a seeded generator."""
    cam = Camera.make(width, width, origin=origin, look_at=(0.0, 0.0, 0.0), device=dev)
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
def test_mega_bwd_one_object_on_card(dev):
    """The worst case for the kernel's warp-aggregated table sums: a mirror
    platform alone under a camera that looks down on it, so every lane
    hits object 0 at bounce 0 (and the reflected rays escape), at 512^2 x
    depth 8.  Checked as the demo scene is, the carry bitwise."""
    b = SceneBuilder()
    b.add_platform(0.0, mat_type=MaterialType.MIRROR, kd=(0.7, 0.6, 0.5), emission=0.3,
                   smoothness=1.5, reflectivity=0.5)
    gs = group_scene(b.build(device=dev))
    args, out = _bwd_inputs(dev, gs, 512, 8, origin=(0.0, 100.0, 1.0))
    assert bool((args[7][0] == 0).all())
    got = mega_bwd(*args, with_carry=True)
    _check_bwd(got, mega_bwd_plain(*args))
    assert float(got[0].abs().sum()) > 0 and float(got[1].abs().sum()) > 0
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


@pytest.mark.gpu
def test_bench_step_matches_loss_grads_on_card(dev):
    """bench.build_bench at 256^2 x 2 spp x d4 against chip_smoke.loss_grads
    on inputs built apart: scene, camera and sky bitwise, the step's
    launches (its first call's warm-up and replay, then a replay's), the
    loss bitwise; the kd and emission gradients within a
    relative L2 error of 1e-4, since mega_bwd's float atomics add the table
    cotangents in another order on every run (csrc/mega_bwd.cu)."""
    import chip_smoke
    from cpppathtracer_tpu_torch.bench import build_bench
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky

    step, scene, camera, sky = build_bench(256, 256, 2, 4, dev)
    s0 = demo_scene(0).build(device=dev)
    cam = Camera.make(256, 256, device=dev, **chip_smoke.CAMERA)
    sky0 = torch.from_numpy(procedural_sky(256, 256)).to(dev)
    assert chip_smoke.same_fields(scene, s0) and chip_smoke.same_fields(camera, cam)
    assert torch.equal(sky, sky0)
    want = dict(mega_trace=4, mega_trace_aux=0, stream_compact=2, stream_expand=2, mega_bwd=2,
                winner_index=0, bvh_winner_index=0, denoise=0)
    kb.reset_launches()
    step()  # the compiled step's first call: its warm-up runs eagerly, then a replay
    torch.cuda.synchronize()
    assert kb.LAUNCHES == {k: 2 * n for k, n in want.items()}
    kb.reset_launches()
    loss, grads = step()
    torch.cuda.synchronize()
    assert kb.LAUNCHES == want
    ref = chip_smoke.loss_grads(s0, cam, sky0, 2, 4)
    assert torch.equal(loss, ref[0])
    for g, r in zip(grads.values(), ref[1:]):
        assert torch.isfinite(g).all() and float((g - r).norm() / r.norm()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("width,aux", [(64, "random"), (1024, "random"), (1024, "no_att")])
def test_mega_bwd_aux_matches_plain_on_card(dev, width, aux):
    """The textured instance (ct_aux: per bounce ct_pos vec3 and ct_att,
    random, zero on the bounces that missed as the texture epilogue gives
    them; "no_att" also zero on every att plane, the Pallas kernel's
    ct_pos form) against mega_bwd_plain(ct_aux=...) on the demo scene at
    depth 8, under _check_bwd's bounds; the aux cotangents move the table
    cotangents, and the rebuilt carry is mega_trace's."""
    gs = group_scene(demo_scene(0).build(device=dev))
    args, out = _bwd_inputs(dev, gs, width, 8)
    hits = args[7]
    g = torch.Generator(device=dev).manual_seed(1)
    ct_aux = torch.randn((32, width * width), device=dev, generator=g)
    ct_aux = torch.where(hits.repeat_interleave(4, 0) >= 0, ct_aux, 0.0)
    if aux == "no_att":
        ct_aux[3::4] = 0.0
    kb.reset_launches()
    got = mega_bwd(*args, ct_aux=ct_aux, with_carry=True)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["mega_bwd"] == 1
    ref = mega_bwd_plain(*args, ct_aux=ct_aux)
    _check_bwd(got, ref)
    base = mega_bwd(*args)
    assert float((got[0] - base[0]).norm() / base[0].norm()) > 1e-3
    carry = got[4]
    for a, b in zip([*carry[0], *carry[1], *carry[2], carry[3]], [*out[8], *out[1], *out[2], out[3]]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_textured_sample_grads_kernel_vs_plain_on_card(dev, monkeypatch):
    """A textured render's gradients (kd, emission, the texture stack) at
    256^2 x 2 spp x d8 through the kernel's textured instance (one
    mega_bwd launch a sample) and through the plain backward (autograd of
    the replay): cosine > 0.9999 and norms within 1e-3."""
    import dataclasses

    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky
    from cpppathtracer_tpu_torch.types import PrimitiveType

    scene = demo_scene(0).build(device=dev)
    tid = torch.where(scene.prim_type == PrimitiveType.CYLINDER, 0, -1).to(torch.int32)
    scene = dataclasses.replace(scene, tex_id=tid)
    tex = torch.from_numpy(procedural_sky(64, 64, seed=1)[None]).to(dev)
    sky = torch.from_numpy(procedural_sky(64, 64)).to(dev)
    cam = Camera.make(256, 256, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device=dev)

    def grads():
        kd = scene.kd.clone().requires_grad_()
        em = scene.emission.clone().requires_grad_()
        t = tex.clone().requires_grad_()
        s = scene.with_material_params({"kd": kd, "emission": em})
        rad, _, _ = render_radiance(s, cam, sky, spp=2, max_depth=8, tex_stack=t)
        return torch.autograd.grad((rad * rad).sum(), (kd, em, t))

    kb.reset_launches()
    k = grads()
    assert kb.LAUNCHES["mega_bwd"] == 2 and kb.LAUNCHES["mega_trace_aux"] == 4
    monkeypatch.setattr(mega, "mega_bwd", mega_bwd_plain)
    p = grads()
    for a, b in zip(k, p):
        a, b = a.flatten().double(), b.flatten().double()
        assert float(b.norm()) > 0
        assert float(a @ b / (a.norm() * b.norm())) > 0.9999
        assert abs(float(a.norm() / b.norm()) - 1) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("with_aux", [False, True])
def test_ladder_and_second_split_on_card(dev, monkeypatch, with_aux):
    """One 1024^2 x d8 sample of the demo scene through the kernels under
    POCA_MEGA_LADDER=1 with the second split, without it, and with
    POCA_MEGA_PREFIX2=1, against the unsplit trace (POCA_MEGA_SPLIT=0):
    hit planes, missed and the first-hit buffers bitwise equal; radiance
    within 5e-7; the ladder alone and PREFIX2 bitwise equal to the
    schedules they partition (the single phase-B launch, the second
    split); aux planes bitwise on every bounce that hit."""
    gs = group_scene(demo_scene(0).build(device=dev))
    cam = Camera.make(1024, 1024, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0),
                      device=dev)
    pix = torch.arange(1024 * 1024, dtype=torch.int32, device=dev)
    switches = ("POCA_MEGA_SPLIT", "POCA_MEGA_LADDER", "POCA_MEGA_SPLIT2", "POCA_MEGA_PREFIX2")

    def sample(**env):
        for k in switches:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        kb.reset_launches()
        with torch.no_grad():
            out = mega.mega_sample(gs, cam, pix, 1, 0, 8, with_aux=with_aux)
        torch.cuda.synchronize()
        return out, dict(kb.LAUNCHES)

    flat = lambda s: [*s[0], *s[1], *s[2], s[3], *s[4], s[5], *s[6]] + (
        [c for p, a in s[7] for c in (*p, a)] if with_aux else [])
    paths = lambda s: [s[3], *s[4], s[5], *s[6]]
    bits = lambda t: t.view(torch.int32)
    s0, _ = sample(POCA_MEGA_SPLIT="0")
    one, _ = sample(POCA_MEGA_LADDER="0")
    lad, n_lad = sample(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="0")
    sp2, n_sp2 = sample(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1")
    pre, n_pre = sample(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1", POCA_MEGA_PREFIX2="1")
    name = "mega_trace_aux" if with_aux else "mega_trace"
    assert (n_lad[name], n_sp2[name], n_pre[name]) == (3, 4, 5)
    assert (n_lad["stream_compact"], n_sp2["stream_compact"]) == (1, 2)
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(flat(lad), flat(one)))
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(flat(pre), flat(sp2)))
    assert all(torch.equal(a, b) for a, b in zip(paths(sp2), paths(s0)))
    for k in range(3):
        assert torch.allclose(sp2[0][k], s0[0][k], rtol=5e-7, atol=5e-7)
    if with_aux:
        for b, ((p1, a1), (p0, a0)) in enumerate(zip(sp2[7], s0[7])):
            hit = s0[6][b] >= 0
            assert all(torch.equal(x[hit], y[hit]) for x, y in zip((*p1, a1), (*p0, a0)))


# ------------------------------------------------- the wavefront path's winners


def _take(ray, lanes):
    """The planar rays (o, d, tmin, tmax) at `lanes`, contiguous."""
    o, d, tmin, tmax = ray
    pick = lambda t: t[lanes].contiguous()
    return tuple(map(pick, o)), tuple(map(pick, d)), pick(tmin), pick(tmax)


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


def _bvh_rays(dev, scene, which, monkeypatch):
    """256^2 rays of big_camera(4096): the primaries, or the rays of
    bounce 1 as trace_bounces hands them to the walk (tmin 2e-5)."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.presets import big_camera
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky

    if which == "primaries":
        return _primaries(dev, 4096, 256)
    calls = []
    real = fast.bvh_winner_index

    def recording(o, d, tmin, tmax, *tables, **kw):
        calls.append((tuple(c.clone() for c in o), tuple(c.clone() for c in d), tmin.clone(),
                      tmax.clone()))
        return real(o, d, tmin, tmax, *tables, **kw)

    monkeypatch.setattr(fast, "bvh_winner_index", recording)
    sky = torch.from_numpy(procedural_sky(64, 64)).to(dev)
    with torch.no_grad():
        render_radiance(scene, big_camera(4096, 256, 256, device=dev), sky, spp=1, max_depth=2)
    monkeypatch.undo()
    return calls[1]


def _nodes_in_smem(scene):
    """Whether the walk kernel stages this scene's nodes in shared memory."""
    import ctypes

    info = (ctypes.c_int * 4)()
    m, k = scene.bvh_dims
    assert kb.library().poca_bvh_info(m, scene.bvh_objs.shape[0] // k, ctypes.addressof(info)) == 0
    return bool(info[3])


def _check_walk(ray, tables, k, hits_min=0.25):
    """The walk kernel against its plain version: one launch, bitwise equal
    indices; returns them."""
    kb.reset_launches()
    got = bvh_kernel.bvh_winner_index(*ray, *tables, leaf_size=k)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["bvh_winner_index"] == 1
    assert torch.equal(got, bvh_kernel.bvh_winner_index_plain(*ray, *tables, leaf_size=k))
    assert float((got > 0).float().mean()) > hits_min
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("rays", ["primaries", "bounce1"])
@pytest.mark.parametrize("leaf_size", [None, 8], ids=["auto", "leaf8"])
def test_bvh_winner_index_matches_plain_on_card(dev, monkeypatch, leaf_size, rays):
    """The BVH walk kernel equals its plain version bitwise on 2^16
    primaries of big_scene(4096) and on its bounce-1 rays, with the
    automatic leaf size (K = 32) and with K = 8 (about 1,000 nodes)."""
    from cpppathtracer_tpu_torch.models.presets import big_scene

    scene = big_scene(4096, bvh=False, device=dev).with_bvh(leaf_size)
    assert _nodes_in_smem(scene)
    ray = _bvh_rays(dev, scene, rays, monkeypatch)
    _check_walk(ray, (scene.bvh_meta, scene.bvh_aabb, scene.bvh_objs), scene.bvh_dims[1],
                hits_min=0.25 if rays == "primaries" else 0.05)


@pytest.mark.gpu
def test_bvh_winner_index_past_node_budget_on_card(dev):
    """big_scene(16384) with K = 8 has 4,095 nodes and 2,048 leaves, 160 KB
    of them, past the kernel's shared-memory budget: the nodes are read
    through the cache, and the walk still equals its plain version."""
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene

    scene = big_scene(16384, bvh=False, device=dev).with_bvh(8)
    m, k = scene.bvh_dims
    assert not _nodes_in_smem(scene)
    cam = big_camera(16384, 256, 256, device=dev)
    r = 256 * 256
    pix = torch.arange(r, dtype=torch.int32, device=dev)
    o, d = cam.ray_gen_planar(pix, torch.zeros_like(pix), 0)
    ray = (tuple(c.contiguous() for c in o), tuple(c.contiguous() for c in d),
           torch.zeros(r, device=dev), torch.full((r,), INF, device=dev))
    _check_walk(ray, (scene.bvh_meta, scene.bvh_aabb, scene.bvh_objs), k)


@pytest.mark.gpu
def test_bvh_winner_index_exact_ties_on_card(dev):
    """Exact t ties within a leaf and across leaves (tests/torch_scenes.py's
    column of overlapping cylinders and stacks of sphere copies): the
    kernel keeps the plain version's winner."""
    scene = tie_scene(dev)
    _check_walk(tie_rays(1 << 16, dev), (scene.bvh_meta, scene.bvh_aabb, scene.bvh_objs),
                scene.bvh_dims[1])


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
def test_winner_index_big_scene_4096_on_card(dev):
    """The dense winner kernel on big_scene(4096), its main path's scene
    (4,112 rows, 131 KB of shared memory, one block of 1024 an SM), on
    256^2 + 7 primaries (the last warp partly masked): bitwise equal to its
    plain version."""
    from cpppathtracer_tpu_torch.models.presets import big_scene
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import winner_index, winner_index_plain

    gs = group_scene(big_scene(4096, bvh=False, device=dev))
    o, d, tmin, tmax = _primaries(dev, 4096, 257)
    cut = lambda v: tuple(c[:256 * 256 + 7].contiguous() for c in v)
    ray = (cut(o), cut(d), tmin[:256 * 256 + 7].contiguous(), tmax[:256 * 256 + 7].contiguous())
    geom = build_geom_rows(gs)
    got = winner_index(gs.counts, *ray, geom)
    assert torch.equal(got, winner_index_plain(gs.counts, *ray, geom))
    assert float((got > 0).float().mean()) > 0.25


@pytest.mark.gpu
def test_winner_index_at_row_limit_on_card(dev):
    """A scene of exactly 7,264 geometry rows (4,000 spheres, 1 platform and
    3,256 cylinders: 232,448 bytes, the card's whole opt-in shared memory
    per block) on 8,192 + 5 random rays through it: bitwise equal to the
    plain version."""
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
        WINNER_SMEM_MAX, winner_index, winner_index_plain,
    )

    rng = np.random.RandomState(5)
    b = SceneBuilder()
    for _ in range(4000):
        b.add_sphere(tuple(rng.uniform(-60, 60, 3)), float(rng.uniform(0.3, 2.0)))
    b.add_platform(-61.0)
    for _ in range(3256):
        b.add_cylinder(tuple(rng.uniform(-60, 60, 3)), float(rng.uniform(0.3, 2.0)),
                       float(rng.uniform(0.5, 4.0)))
    gs = group_scene(b.build(device=dev, bvh=False))
    geom = build_geom_rows(gs)
    assert 32 * geom.shape[0] == WINNER_SMEM_MAX
    r = 8192 + 5
    o = rng.uniform(-80, 80, (3, r)).astype(np.float32)
    d = rng.normal(size=(3, r)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    f = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in a)
    ray = (f(o), f(d), torch.zeros(r, device=dev), torch.full((r,), INF, device=dev))
    got = winner_index(gs.counts, *ray, geom)
    assert torch.equal(got, winner_index_plain(gs.counts, *ray, geom))
    assert float((got > 0).float().mean()) > 0.25


@pytest.mark.gpu
def test_winner_index_exact_ties_on_card(dev):
    """Exact t ties (tests/torch_scenes.py's column of overlapping cylinders
    and stacks of sphere copies) on 2^16 + 3 rays: the dense kernel keeps
    the plain version's winner, the lowest grouped index."""
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import winner_index, winner_index_plain

    gs = group_scene(tie_scene(dev))
    ray = tie_rays((1 << 16) + 3, dev)
    geom = build_geom_rows(gs)
    got = winner_index(gs.counts, *ray, geom)
    assert torch.equal(got, winner_index_plain(gs.counts, *ray, geom))
    assert float((got > 0).float().mean()) > 0.25


@pytest.mark.gpu
def test_winner_index_past_one_tile_on_card(dev):
    """A scene of 14,008 geometry rows (8,000 spheres, 1 platform and
    6,000 cylinders), past the 7,264 one block stages, on 8,192 + 5 random
    rays: the launch searches it in two tiles (the first ends inside the
    spheres) and equals the plain search over one tile bitwise."""
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
        WINNER_TILE_ROWS, winner_index, winner_t_index_plain,
    )

    rng = np.random.RandomState(6)
    b = SceneBuilder()
    for _ in range(8000):
        b.add_sphere(tuple(rng.uniform(-80, 80, 3)), float(rng.uniform(0.3, 2.0)))
    b.add_platform(-81.0)
    for _ in range(6000):
        b.add_cylinder(tuple(rng.uniform(-80, 80, 3)), float(rng.uniform(0.3, 2.0)),
                       float(rng.uniform(0.5, 4.0)))
    gs = group_scene(b.build(device=dev, bvh=False))
    geom = build_geom_rows(gs)
    assert geom.shape[0] == 14008 > WINNER_TILE_ROWS
    r = 8192 + 5
    o = rng.uniform(-100, 100, (3, r)).astype(np.float32)
    d = rng.normal(size=(3, r)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    f = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in a)
    ray = (f(o), f(d), torch.zeros(r, device=dev), torch.full((r,), INF, device=dev))
    kb.reset_launches()
    got = winner_index(gs.counts, *ray, geom)
    assert kb.LAUNCHES["winner_index"] == 1
    ref = torch.cat([winner_t_index_plain(gs.counts, *_take(ray, part), geom, 14008)[1]
                     for part in torch.arange(r, device=dev).split(2048)])
    assert torch.equal(got, ref)
    assert float((got > 0).float().mean()) > 0.25


@pytest.mark.gpu
@pytest.mark.parametrize("tile_rows", [8, 16, 24])
def test_winner_index_small_tiles_exact_ties_on_card(dev, tile_rows):
    """tests/torch_scenes.py's exact ties on 2^16 + 3 rays, searched in
    tiles of 8, 16 or 24 rows (tiles that start and end inside the type
    groups): bitwise equal to the plain search over one tile, so a later
    tile takes a winner only when strictly closer."""
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
        winner_index, winner_t_index_plain,
    )

    gs = group_scene(tie_scene(dev))
    ray = tie_rays((1 << 16) + 3, dev)
    geom = build_geom_rows(gs)
    got = winner_index(gs.counts, *ray, geom, tile_rows=tile_rows)
    assert torch.equal(got, winner_t_index_plain(gs.counts, *ray, geom, geom.shape[0])[1])
    assert float((got > 0).float().mean()) > 0.25


@pytest.mark.gpu
def test_sharded_render_virtual_mesh_bitwise_on_card(dev):
    """The demo scene at 192x135 (a mesh that pads the rows), 2 spp, depth
    6, tiled over a virtual 2x2 mesh on one card: bitwise equal to the
    unsharded render, through the kernels (the ray counter and the
    compaction reorder lanes, not arithmetic).  The tiles replay one
    render graph (one device, one tile shape), captured by the first
    frame; the second frame's replays launch the kernels of four eager
    tiles."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.parallel.render import render_image_sharded, tile_graphs

    scene = demo_scene(0).build(device=dev)
    cam = Camera.make(192, 135, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device=dev)
    sky = torch.from_numpy(procedural_sky(64, 64)).to(dev)
    mesh = make_tile_mesh([dev] * 4)
    first = render_image_sharded(scene, cam, sky, mesh, spp=2, max_depth=6, seed=3)
    kb.reset_launches()
    got = render_image_sharded(scene, cam, sky, mesh, spp=2, max_depth=6, seed=3)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["mega_trace"] == 2 * 2 * 4  # phase A and B, 2 samples, 4 tiles
    assert len(tile_graphs(mesh).keys()) == 1 and all(map(torch.equal, first, got))
    with torch.no_grad():
        rad, n0, t0 = render_radiance(scene, cam, sky, spp=2, max_depth=6, seed=3)
    for a, b in zip(got, (rad.reshape(135, 192, 3), n0.reshape(135, 192, 3), t0.reshape(135, 192))):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_frame_sink_writes_cuda_frames(dev, tmp_path):
    """AsyncFrameSink takes uint8 frames on the card; each PNG holds the
    frame's bytes, equal to to_rgb8 of its float frame."""
    from PIL import Image

    from cpppathtracer_tpu_torch.renderer import to_rgb8
    from cpppathtracer_tpu_torch.video import AsyncFrameSink

    g = torch.Generator(device=dev).manual_seed(0)
    frames = [torch.rand((64, 96, 3), device=dev, generator=g) * 1.2 - 0.1 for _ in range(12)]
    sink = AsyncFrameSink(str(tmp_path))
    for i, f in enumerate(frames):
        sink.put(i, (255.99 * torch.clamp(f, 0.0, 1.0)).to(torch.uint8))
    sink.close()
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(np.asarray(Image.open(sink.path(i))), to_rgb8(f))


@pytest.mark.gpu
def test_frame_sink_waits_for_the_stream_that_made_the_frame(dev, tmp_path):
    """Frames made on a side stream, each right after a long kernel there,
    and handed to AsyncFrameSink at once: every PNG holds its frame's
    final bytes (the writer waits for the stream that made the frame, not
    for its own)."""
    from PIL import Image

    from cpppathtracer_tpu_torch.video import AsyncFrameSink

    side = torch.cuda.Stream(dev)
    big = torch.rand((4096, 4096), device=dev)
    sink = AsyncFrameSink(str(tmp_path))
    want = []
    with torch.cuda.stream(side):
        for i in range(6):
            frame = torch.full((48, 64, 3), 0, dtype=torch.uint8, device=dev)
            for _ in range(3):
                big = big @ big.T / 4096.0  # device work the frame waits behind
            frame.fill_(40 * i + 1)
            sink.put(i, frame)
            want.append(40 * i + 1)
    sink.close()
    for i, v in enumerate(want):
        assert (np.asarray(Image.open(sink.path(i))) == v).all()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_rowmajor_winner_launch_matches_plain_on_card(dev, layout):
    """fast.winner_index_rowmajor on row-major Rays (origin and dir
    f32[R, 3], whose columns are strided views, or the same rays from a
    transposed copy, whose columns are contiguous) launches winner_index
    once and equals winner_index_plain bitwise, and intersect_and_gather
    on the card takes that launch and returns the plain winners' object
    ids."""
    from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import winner_index_plain
    from cpppathtracer_tpu_torch.types import Rays

    gs = group_scene(demo_scene(0).build(device=dev))
    cam = Camera.make(256, 256, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device=dev)
    rays = cam.ray_gen(torch.arange(R, dtype=torch.int32, device=dev), 3, 1)
    if layout == "contiguous":
        cols = lambda a: a.T.contiguous().T  # f32[R, 3] over contiguous columns
        rays = Rays(cols(rays.origin), cols(rays.dir), rays.tmin, rays.tmax)
        assert rays.origin[:, 0].is_contiguous()
    else:
        assert not rays.origin[:, 0].is_contiguous()
    kb.reset_launches()
    got = fast.winner_index_rowmajor(gs, rays)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["winner_index"] == 1
    planes = [rays.origin[:, c].contiguous() for c in range(3)]
    dirs = [rays.dir[:, c].contiguous() for c in range(3)]
    want = winner_index_plain(gs.counts, planes, dirs, rays.tmin, rays.tmax, build_geom_rows(gs))
    assert torch.equal(got, want)
    assert float((got > 0).float().mean()) > 0.25
    hit, _ = fast.intersect_and_gather(gs, rays)
    assert kb.LAUNCHES["winner_index"] == 2
    assert torch.equal(hit.obj_idx, torch.where(hit.hit, gs.table_s[want.long(), 12].int(), -1))


@pytest.mark.gpu
def test_stack_bvh_walk_on_card_matches_cpu(dev):
    """intersect_bvh over build_bvh on the card equals the same walk on
    the CPU (same inputs, the same float32 operations) on 4096 rays of a
    300-object scene: winners equal, t and normals within 1e-6."""
    from cpppathtracer_tpu_torch.ops.bvh import build_bvh, intersect_bvh
    from cpppathtracer_tpu_torch.types import Rays

    rng = np.random.RandomState(6)
    b = SceneBuilder()
    b.add_platform(0.0)
    for _ in range(300):
        c = rng.uniform(-60, 60, 3)
        c[1] = rng.uniform(1, 20)
        b.add_sphere(tuple(c), float(rng.uniform(1, 5)))
    o = rng.uniform(-80, 80, (4096, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 40, 4096)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hits = []
    for where in ("cpu", dev):
        scene = b.build(device=where, bvh=False)
        hits.append(intersect_bvh(scene, build_bvh(scene), Rays.make(o, d, device=where)))
    cpu, card = hits
    assert torch.equal(card.obj_idx.cpu(), cpu.obj_idx)
    assert float(cpu.hit.float().mean()) > 0.25
    torch.testing.assert_close(card.t.cpu(), cpu.t, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(card.normal.cpu(), cpu.normal, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_video_harness_on_card(dev, tmp_path):
    """scripts/torch_bench_video.py at 64^2 x 1 spp x d2 on the card: one
    stdout line, and frame 0 of the timed orbit bitwise the warm-up's (its
    PNG's SHA-256): the forward render is deterministic on the card."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = tmp_path / "video.json"
    proc = subprocess.run([sys.executable, "scripts/torch_bench_video.py", "--frames", "3",
                           "--size", "64", "--spp", "1", "--depth", "2", "--out", str(out)],
                          cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(proc.stdout.splitlines()) == 1, proc.stdout
    res = json.loads(out.read_text())
    assert res["backend"] == "cuda" and len(res["frame_sha256_16"]) == 3
    assert res["frame_sha256_16"][0] == res["warmup_frame0_sha256_16"]
    assert res["busy_ms_per_frame"] > 0


# ---- the denoise kernel and the compiled serving calls


# odd sizes, H or W under 5, the 32 x 16 tile exactly, one pixel under and over a multiple of
# it in each direction
DENOISE_SIZES = [(48, 64), (720, 1280), (29, 37), (3, 17), (1, 1), (4, 2), (16, 32), (15, 31),
                 (17, 33), (31, 65), (33, 63)]


@pytest.mark.gpu
@pytest.mark.parametrize("stepwidth", [0, 1, 2, 3])
@pytest.mark.parametrize("h,w", DENOISE_SIZES)
def test_denoise_kernel_matches_plain_on_card(dev, h, w, stepwidth):
    """csrc/denoise.cu bitwise equal to its plain version on seeded inputs
    (radiance in [0, 2), normals N(0, 1), depth in [0, 50)), one launch:
    the tiled kernel of stepwidth 1 and the untiled one of the others (0,
    2 and 3)."""
    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise, denoise_plain

    g = torch.Generator(device=dev).manual_seed(h * 1000 + w)
    rad = 2 * torch.rand((h, w, 3), device=dev, generator=g)
    nrm = torch.randn((h, w, 3), device=dev, generator=g)
    dep = 50 * torch.rand((h, w), device=dev, generator=g)
    kb.reset_launches()
    got = denoise(rad, nrm, dep, stepwidth)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["denoise"] == 1
    ref = denoise_plain(rad, nrm, dep, stepwidth)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("stepwidth", [0, 1, 2, 3])
@pytest.mark.parametrize("h,w", [(720, 1280), (33, 63)])
def test_denoise_kernel_inf_nan_on_card(dev, h, w, stepwidth):
    """A radiance with inf and NaN (inside the image and at its edges):
    the kernel's NaN exactly where the plain version's, every other value
    bitwise."""
    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise, denoise_plain

    g = torch.Generator(device=dev).manual_seed(h + w)
    rad = 2 * torch.rand((h, w, 3), device=dev, generator=g)
    nrm = torch.randn((h, w, 3), device=dev, generator=g)
    dep = 50 * torch.rand((h, w), device=dev, generator=g)
    for y, x, c, v in ((h // 2, w // 3, 0, float("inf")), (0, w - 1, 1, float("nan")),
                       (h - 1, 0, 2, -float("inf")), (h // 3, w // 2, 1, float("nan"))):
        rad[y, x, c] = v
    got, ref = denoise(rad, nrm, dep, stepwidth), denoise_plain(rad, nrm, dep, stepwidth)
    nan = torch.isnan(ref)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("stepwidth", [16, 17, 40, 300])
def test_denoise_kernel_wide_stepwidth_on_card(dev, stepwidth):
    """Wide stepwidths launch one kernel and match the plain version
    bitwise (a staged tile and halo would outgrow shared memory past
    some 15): the untiled kernel reads its taps from device memory, up to
    300, where every tap but the centre lies outside the frame."""
    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise, denoise_plain

    g = torch.Generator(device=dev).manual_seed(stepwidth)
    rad = 2 * torch.rand((40, 70, 3), device=dev, generator=g)
    nrm = torch.randn((40, 70, 3), device=dev, generator=g)
    dep = 50 * torch.rand((40, 70), device=dev, generator=g)
    kb.reset_launches()
    got = denoise(rad, nrm, dep, stepwidth)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["denoise"] == 1
    ref = denoise_plain(rad, nrm, dep, stepwidth)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
def test_denoise_kernel_refuses_grad_inputs_on_card(dev):
    """The kernel has no backward: a radiance that requires grad under grad
    mode raises ValueError before any launch; under no_grad it launches."""
    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise, denoise_plain

    g = torch.Generator(device=dev).manual_seed(5)
    rad = torch.rand((24, 32, 3), device=dev, generator=g).requires_grad_()
    nrm = torch.randn((24, 32, 3), device=dev, generator=g)
    dep = torch.rand((24, 32), device=dev, generator=g)
    kb.reset_launches()
    with pytest.raises(ValueError, match="no backward"):
        denoise(rad, nrm, dep)
    assert kb.LAUNCHES["denoise"] == 0
    with torch.no_grad():
        got = denoise(rad, nrm, dep)
        ref = denoise_plain(rad, nrm, dep)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["denoise"] == 1 and torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _serving_scene(dev, which, size=64):
    from cpppathtracer_tpu_torch.models.presets import big_camera, big_scene
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky

    sky = torch.from_numpy(procedural_sky(64, 64)).to(dev)
    if which == "bvh":
        return big_scene(4096, device=dev), big_camera(4096, size, size, device=dev), sky
    cam = Camera.make(size, size, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0),
                      device=dev)
    return demo_scene(0).build(device=dev), cam, sky


def _bits_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["demo", "bvh"])
def test_render_radiance_jit_bitwise_on_card(dev, which):
    """render_radiance_jit replays its CUDA graphs bitwise equal to the
    eager render_radiance (demo_scene(0) on the megakernel, big_scene(4096)
    on the BVH walk, 64^2 x 4 spp x d8, at two sample offsets), and a
    replay adds the kernels' launches of the eager render."""
    from cpppathtracer_tpu_torch.integrator import (
        RENDER_GRAPHS, render_radiance, render_radiance_jit,
    )

    scene, cam, sky = _serving_scene(dev, which)
    RENDER_GRAPHS.clear()
    captures = RENDER_GRAPHS.captures
    with torch.no_grad():
        for offset in (0, 5):
            kw = dict(spp=4, max_depth=8, seed=3, sample_offset=offset)
            got = render_radiance_jit(scene, cam, sky, **kw)
            kb.reset_launches()
            got = render_radiance_jit(scene, cam, sky, **kw)
            torch.cuda.synchronize()
            replayed = dict(kb.LAUNCHES)
            kb.reset_launches()
            ref = render_radiance(scene, cam, sky, **kw)
            torch.cuda.synchronize()
            assert replayed == kb.LAUNCHES and sum(replayed.values()) > 0
            assert _bits_equal(got, ref)
    assert RENDER_GRAPHS.captures - captures == 2  # the first chunk's body and a later one's
    RENDER_GRAPHS.clear()


@pytest.mark.gpu
def test_render_radiance_jit_replays_after_in_place_edit_on_card(dev):
    """An in-place edit of kd and a moved camera between replays: bitwise
    the eager render of the edited scene, with no new capture."""
    from cpppathtracer_tpu_torch.integrator import (
        RENDER_GRAPHS, render_radiance, render_radiance_jit,
    )

    scene, cam, sky = _serving_scene(dev, "demo")
    RENDER_GRAPHS.clear()
    kw = dict(spp=2, max_depth=8, seed=0)
    with torch.no_grad():
        render_radiance_jit(scene, cam, sky, **kw)
        captures = RENDER_GRAPHS.captures
        scene.kd.mul_(0.5)
        cam = cam.move_forward(2.0)
        got = render_radiance_jit(scene, cam, sky, **kw)
        assert _bits_equal(got, render_radiance(scene, cam, sky, **kw))
    assert RENDER_GRAPHS.captures == captures
    RENDER_GRAPHS.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("denoise", [True, False])
def test_progressive_frames_graphed_bitwise_on_card(dev, denoise):
    """Four frames of ProgressiveRenderer.step (its CUDA graph) bitwise
    equal to the eager frame_step, the denoise kernel launched once a frame
    when on."""
    from cpppathtracer_tpu_torch.renderer import (
        AccumulatorState, ProgressiveRenderer, RenderConfig, frame_step,
    )

    scene, cam, sky = _serving_scene(dev, "demo")
    cfg = RenderConfig(width=64, height=64, max_depth=8, denoise=denoise)
    r = ProgressiveRenderer(scene, cam, sky, cfg)
    state = AccumulatorState.create(64, 64, dev)
    for k in range(4):
        kb.reset_launches()
        img = r.step()  # the first step also warms the frame's body up and captures it
        torch.cuda.synchronize()
        frame_launches = dict(kb.LAUNCHES)
        state, ref = frame_step(scene, cam, sky, state, cfg.seed, cfg.max_depth, denoise)
        assert torch.equal(img.view(torch.int32), ref.view(torch.int32))
        if k:
            assert frame_launches["denoise"] == int(denoise) and frame_launches["mega_trace"] == 2
    assert r.graphs.captures == 1 and r.state.sample_idx == 4


@pytest.mark.gpu
def test_failed_capture_raises_and_runs_nothing_eagerly_on_card(dev, monkeypatch):
    """A body that reads a value on the host cannot be captured: the call
    raises, and after the warm-up (one eager run of the body) nothing runs
    in the graph's place.  The card stays usable."""
    from cpppathtracer_tpu_torch import integrator
    from cpppathtracer_tpu_torch.utils.graphs import GraphedCall

    scene, cam, sky = _serving_scene(dev, "demo")
    epilogue = integrator.sky_epilogue

    def syncing_epilogue(*args):
        out = epilogue(*args)
        float(out.sum())  # a host read: capture refuses it
        return out

    monkeypatch.setattr(integrator, "sky_epilogue", syncing_epilogue)
    kb.reset_launches()
    stream = torch.cuda.current_stream(dev)
    with torch.no_grad(), pytest.raises(RuntimeError, match="capture"):
        integrator.render_graphed(GraphedCall(), scene, cam, sky, spp=1, max_depth=8)
    assert kb.LAUNCHES["mega_trace"] == 2  # the warm-up's sample alone
    assert torch.cuda.current_stream(dev) == stream  # not the failed capture's stream
    monkeypatch.setattr(integrator, "sky_epilogue", epilogue)
    with torch.no_grad():
        out = integrator.render_radiance(scene, cam, sky, spp=1, max_depth=8)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all()


@pytest.mark.gpu
def test_serving_calls_off_the_current_device_on_card(dev):
    """With the scene on cuda:1 and cuda:0 current, render_radiance_jit (at
    two sample offsets through one capture) and four ProgressiveRenderer
    steps with the denoiser are bitwise the eager render_radiance and
    frame_step: the graphs are captured and replayed on the scene's card,
    and the current device is left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from cpppathtracer_tpu_torch.integrator import (
        RENDER_GRAPHS, render_radiance, render_radiance_jit,
    )
    from cpppathtracer_tpu_torch.renderer import (
        AccumulatorState, ProgressiveRenderer, RenderConfig, frame_step,
    )

    torch.cuda.set_device(0)
    dev1 = torch.device("cuda:1")
    scene, cam, sky = _serving_scene(dev1, "demo")
    RENDER_GRAPHS.clear()
    captures = RENDER_GRAPHS.captures
    with torch.no_grad():
        for offset in (0, 5):
            kw = dict(spp=4, max_depth=8, seed=3, sample_offset=offset)
            got = render_radiance_jit(scene, cam, sky, **kw)
            ref = render_radiance(scene, cam, sky, **kw)
            torch.cuda.synchronize(dev1)
            assert got[0].device == dev1 and _bits_equal(got, ref)
    assert RENDER_GRAPHS.captures - captures == 2
    RENDER_GRAPHS.clear()
    cfg = RenderConfig(width=64, height=64, max_depth=8, denoise=True)
    r = ProgressiveRenderer(scene, cam, sky, cfg)
    state = AccumulatorState.create(64, 64, dev1)
    for _ in range(4):
        img = r.step()
        state, ref = frame_step(scene, cam, sky, state, cfg.seed, cfg.max_depth, True)
        torch.cuda.synchronize(dev1)
        assert img.device == dev1 and torch.equal(img.view(torch.int32), ref.view(torch.int32))
    assert r.graphs.captures == 1 and torch.cuda.current_device() == 0


def _rel(a, b):
    """Relative L2 difference of a from b, in float64."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm()) if b.norm() > 0 else float((a - b).norm())


def _worst(x, y):
    return max(_rel(x[k], y[k]) for k in x)


def _held_to_eager(got, runs):
    """Whether `got` (a dict of tensors) lies within twice the eager runs'
    own run-to-run difference (the largest difference between two of them;
    mega_bwd's float atomics and index_add_ sum in another order on each
    run) of the nearest eager run, or is bitwise theirs where they repeat
    bitwise."""
    bar = max(_worst(x, y) for i, x in enumerate(runs) for y in runs[i + 1:])
    if bar == 0.0:
        return all(torch.equal(got[k].view(torch.int32), runs[0][k].view(torch.int32))
                   for k in got)
    return min(_worst(got, r) for r in runs) <= 2 * bar


def _target_of(scene, cam, sky):
    from cpppathtracer_tpu_torch.integrator import render_radiance

    g = torch.Generator(device=scene.device).manual_seed(1)
    kd = (scene.kd + 0.2 * torch.rand(scene.kd.shape, device=scene.device, generator=g)
          - 0.1).clamp(0, 1)
    with torch.no_grad():
        return render_radiance(scene.with_material_params({"kd": kd}), cam, sky, spp=2,
                               max_depth=8, seed=0)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["demo", "bvh"])
def test_compiled_train_steps_on_card(dev, which):
    """At 128^2 x 2 spp x d8 on the megakernel (demo_scene(0)) and on the
    wavefront path (big_scene(4096), BVH walk): (1) bench.train_step_jit
    against bench.train_step: the loss bit for bit, the replay's launches
    the eager step's, the gradients held to three eager runs by
    _held_to_eager; (2) three steps of inverse.make_train_step's
    compiled step (fresh samples, kd and emission) against three of the
    eager step, run three times: the first loss bit for bit, the parameters
    and losses after three steps held the same way, one capture, and a
    replay's launches the eager step's."""
    from cpppathtracer_tpu_torch import bench
    from cpppathtracer_tpu_torch.inverse import InverseConfig, make_train_step

    scene, cam, sky = _serving_scene(dev, which, size=128)
    bench.BENCH_GRAPHS.clear()
    captures = bench.BENCH_GRAPHS.captures
    got = bench.train_step_jit(scene, cam, sky, 2, 8)  # warm-up, capture, one replay
    kb.reset_launches()
    loss, grads = bench.train_step_jit(scene, cam, sky, 2, 8)
    torch.cuda.synchronize()
    replayed = dict(kb.LAUNCHES)
    runs = []
    for _ in range(3):
        kb.reset_launches()
        ref_loss, ref = bench.train_step(scene, cam, sky, 2, 8)
        torch.cuda.synchronize()
        runs.append(ref)
    assert replayed == kb.LAUNCHES and sum(replayed.values()) > 0
    assert torch.equal(loss.view(torch.int32), ref_loss.view(torch.int32))
    assert torch.equal(got[0].view(torch.int32), loss.view(torch.int32))
    assert _held_to_eager(grads, runs), [{k: _rel(grads[k], r[k]) for k in grads} for r in runs]
    assert bench.BENCH_GRAPHS.captures - captures == 1
    bench.BENCH_GRAPHS.clear()

    target = _target_of(scene, cam, sky)
    cfg = InverseConfig(spp=2, max_depth=8, fields=("kd", "emission"))
    finals, first = [], []
    for eager in (False, True, True, True):
        init, step = make_train_step(cam, cfg, eager=eager)
        params, opt = init(scene, sky)
        losses = []
        for k in range(3):
            kb.reset_launches()
            params, opt, l = step(params, opt, scene, sky, target, k)
            torch.cuda.synchronize()
            losses.append(l)
            if k == 2:
                launches = dict(kb.LAUNCHES)
        first.append(losses[0])
        finals.append(dict(params["mat"], loss=losses[2]))
        if eager:
            assert launches == compiled_launches
        else:
            compiled_launches = launches
            assert step.graphs.captures == 1
            step.graphs.clear()
    assert all(torch.equal(first[0].view(torch.int32), f.view(torch.int32)) for f in first)
    assert _held_to_eager(finals[0], finals[1:]), [
        {k: _rel(finals[0][k], f[k]) for k in f} for f in finals[1:]]


@pytest.mark.gpu
def test_train_graphs_clear_frees_their_memory_on_card(dev):
    """The compiled bench step at 128^2 x 4 spp x d8 holds its graph's
    private memory pool and buffers between calls; BENCH_GRAPHS.clear()
    gives back every byte allocated for it and every segment of its pool
    (once the allocator's free cache is released).  The allocator's own
    pool is not counted: after a failed capture earlier in the process
    (test_failed_capture_raises_and_runs_nothing_eagerly_on_card),
    empty_cache was seen to keep the warm-up's free 2 MiB segments."""
    import gc

    from cpppathtracer_tpu_torch import bench

    def pooled():
        """Bytes of the segments that belong to a CUDA graph's pool."""
        return sum(x["total_size"] for x in torch.cuda.memory_snapshot()
                   if tuple(x["segment_pool_id"]) != (0, 0))

    scene, cam, sky = _serving_scene(dev, "demo", size=128)
    bench.BENCH_GRAPHS.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = pooled(), torch.cuda.memory_allocated(dev)
    bench.train_step_jit(scene, cam, sky, 4, 8)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = pooled() - before[0], torch.cuda.memory_allocated(dev) - before[1]
    bench.BENCH_GRAPHS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = pooled() - before[0], torch.cuda.memory_allocated(dev) - before[1]
    assert held[0] > 16 * 2**20 and held[1] > 0, held
    assert after == (0, 0), (held, after)


# ---- the seed as a device word; the compiled video and tiles


SEEDS = [0, 1, 2**31 + 5, -3]


@pytest.mark.gpu
@pytest.mark.parametrize("with_aux", [False, True])
def test_mega_trace_seed_word_on_card(dev, with_aux):
    """mega_trace (both forms) with the seed as an i32 device word: at
    seeds 0, 1, 2^31 + 5 and -3 the bits of the same kernel given the int,
    and the plain version's hit planes and outputs under
    test_mega_trace_matches_plain_on_card's bounds."""
    from cpppathtracer_tpu_torch.utils.rng import seed_word

    gs, args = _demo(dev)
    flat = lambda out: [t for x in out[:6] for t in (x if isinstance(x, tuple) else (x,))] + [
        *out[6]] + ([c for pos, att in out[7] for c in (*pos, att)] if with_aux else [])
    for seed in SEEDS:
        a = list(args)
        a[4] = seed
        by_int = mega_trace(*a, counts=gs.counts, depth=8, with_aux=with_aux)
        a[4] = seed_word(seed, dev).reshape(())
        by_word = mega_trace(*a, counts=gs.counts, depth=8, with_aux=with_aux)
        ref = mega_trace_plain(*a, counts=gs.counts, depth=8, with_aux=with_aux)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(flat(by_int), flat(by_word)))
        agree = (torch.stack(by_word[6]) == torch.stack(ref[6])).all(0)
        assert float(agree.float().mean()) >= 0.999
        fg = torch.stack(flat(by_word)[:14])[:, agree]
        fr = torch.stack(flat(ref)[:14])[:, agree]
        assert torch.allclose(fg, fr, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("aux", [False, True])
def test_mega_bwd_seed_word_on_card(dev, aux):
    """mega_bwd (its untextured and textured instances) with the seed as a
    device word: at each of the four seeds, ct_o, ct_d and the rebuilt
    carry bitwise the kernel's given the int, the table cotangents within
    _check_bwd's relative bound (the atomics add in another order each
    run), and the plain version under _check_bwd's bounds."""
    from cpppathtracer_tpu_torch.utils.rng import seed_word

    gs = group_scene(demo_scene(0).build(device=dev))
    for seed in SEEDS:
        args, _ = _bwd_inputs(dev, gs, 64, 8, seed=seed)
        hits = args[7]
        kw = {}
        if aux:
            g = torch.Generator(device=dev).manual_seed(1)
            ct_aux = torch.randn((32, 64 * 64), device=dev, generator=g)
            kw["ct_aux"] = torch.where(hits.repeat_interleave(4, 0) >= 0, ct_aux, 0.0)
        by_int = mega_bwd(*args, with_carry=True, **kw)
        word = list(args)
        word[4] = seed_word(seed, dev)
        by_word = mega_bwd(*word, with_carry=True, **kw)
        torch.cuda.synchronize()
        for x, y in zip([*by_int[2], *by_int[3], *by_int[4][0], *by_int[4][1], *by_int[4][2],
                         by_int[4][3]],
                        [*by_word[2], *by_word[3], *by_word[4][0], *by_word[4][1],
                         *by_word[4][2], by_word[4][3]]):
            assert torch.equal(x, y)
        _check_bwd(by_word, by_int)
        _check_bwd(by_word, mega_bwd_plain(*word, **kw))


@pytest.mark.gpu
def test_one_render_graph_serves_every_seed_on_card(dev):
    """render_radiance_jit at seeds 0, 1, 2 and 2^31 + 5 (and the last as a
    device tensor): one capture, each bitwise the eager render at its
    seed; ProgressiveRenderer.step over configs that differ in seed alone
    shares one frame graph, bitwise frame_step."""
    from cpppathtracer_tpu_torch.integrator import (
        RENDER_GRAPHS, render_radiance, render_radiance_jit,
    )
    from cpppathtracer_tpu_torch.renderer import (
        AccumulatorState, ProgressiveRenderer, RenderConfig, frame_step,
    )
    from cpppathtracer_tpu_torch.utils.graphs import GraphedCall
    from cpppathtracer_tpu_torch.utils.rng import seed_word

    scene, cam, sky = _serving_scene(dev, "demo")
    RENDER_GRAPHS.clear()
    captures = RENDER_GRAPHS.captures
    with torch.no_grad():
        for seed in (0, 1, 2, 2**31 + 5, seed_word(2**31 + 5, dev).reshape(())):
            got = render_radiance_jit(scene, cam, sky, spp=4, max_depth=8, seed=seed)
            assert _bits_equal(got, render_radiance(scene, cam, sky, spp=4, max_depth=8,
                                                    seed=seed))
            assert RENDER_GRAPHS.captures - captures == 2 and len(RENDER_GRAPHS.keys()) == 1
    RENDER_GRAPHS.clear()
    graphs = GraphedCall(max_entries=2)
    for seed in (0, 1, 2):
        cfg = RenderConfig(width=64, height=64, max_depth=8, seed=seed)
        r = ProgressiveRenderer(scene, cam, sky, cfg)
        r.graphs = graphs
        state = AccumulatorState.create(64, 64, dev)
        for _ in range(2):
            img = r.step()
            state, ref = frame_step(scene, cam, sky, state, seed, cfg.max_depth, cfg.denoise)
            assert torch.equal(img.view(torch.int32), ref.view(torch.int32))
    assert graphs.captures == 1
    graphs.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("tiled", [False, True])
def test_compiled_video_writes_the_eager_pngs_on_card(dev, tmp_path, tiled):
    """render_video on the card (the compiled frame, or with a virtual 2x2
    mesh the tile graphs and the compiled denoise and pack) against the
    eager loop (write_frames with no runner): six 64^2 x 2 spp x d8 orbit
    frames, every PNG byte-equal, one frame entry captured; a second
    video of other cameras and seeds captures nothing more."""
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.parallel.render import tile_graphs
    from cpppathtracer_tpu_torch.video import VIDEO_GRAPHS, orbit_path, render_video, write_frames

    scene, cam, sky = _serving_scene(dev, "demo")
    mesh = make_tile_mesh([dev] * 4) if tiled else None
    kw = dict(spp=2, max_depth=8, mesh=mesh)
    VIDEO_GRAPHS.clear()
    captures = VIDEO_GRAPHS.captures
    for k, (cams, seed) in enumerate(((orbit_path(cam, 6), 0),
                                      (orbit_path(cam.move_forward(3.0), 4), 17))):
        got = render_video(scene, cams, sky, str(tmp_path / f"c{k}"), seed=seed, **kw)
        want = write_frames(None, scene, cams, sky, str(tmp_path / f"e{k}"), seed=seed, **kw)
        assert [open(p, "rb").read() for p in got] == [open(p, "rb").read() for p in want]
        assert len(VIDEO_GRAPHS.keys()) == 1
        # the pack; or the first chunk, a later one and the pack
        assert VIDEO_GRAPHS.captures - captures == (1 if tiled else 3)
        if tiled:
            assert len(tile_graphs(mesh).keys()) == 1 and tile_graphs(mesh).captures == 2
    VIDEO_GRAPHS.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (3, 2)])
def test_tile_graphs_bitwise_eager_tiles_on_card(dev, shape):
    """render_image_sharded on the card (each tile a replay of its
    device's and shape's render graph) against the eager tiles
    (render_tiles with no runner) at 96x72 x 2 spp x d8 on virtual meshes,
    the 3x2 one padding the rows: bitwise, one key, and a second frame at
    another seed and camera captures nothing more."""
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.parallel.render import (
        render_image_sharded, render_tiles, tile_graphs,
    )

    scene, _, sky = _serving_scene(dev, "demo")
    cam = Camera.make(96, 72, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0), device=dev)
    mesh = make_tile_mesh([dev] * (shape[0] * shape[1]), shape=shape)
    for seed, c in ((0, cam), (5, cam.move_forward(2.0))):
        got = render_image_sharded(scene, c, sky, mesh, spp=2, max_depth=8, seed=seed)
        want = render_tiles(None, scene, c, sky, mesh, spp=2, max_depth=8, seed=seed)
        assert _bits_equal(got, want)
        assert len(tile_graphs(mesh).keys()) == 1 and tile_graphs(mesh).captures == 2
    tile_graphs(mesh).clear()


@pytest.mark.gpu
def test_fit_with_sgd_on_card(dev):
    """fit(..., optimizer=sgd(lr), callback=...) on the card: the compiled
    step captures the optimizer's update; its losses bitwise the eager
    step's (make_train_step(eager=True)) for three steps with fixed
    samples, and the callback reads params["mat"]["kd"]."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.inverse import InverseConfig, fit, make_train_step, sgd

    scene, cam, sky = _serving_scene(dev, "demo")
    cfg = InverseConfig(spp=2, max_depth=4, fields=("kd",), fixed_samples=True)
    with torch.no_grad():
        target, _, _ = render_radiance(scene.with_material_params({"kd": scene.kd * 0.8}), cam,
                                       sky, spp=2, max_depth=4)
    seen = []
    _, losses = fit(scene, cam, sky, target, cfg, steps=3, optimizer=sgd(0.5),
                    callback=lambda s, loss, p: seen.append(p["mat"]["kd"].clone()))
    init, step = make_train_step(cam, cfg, optimizer=sgd(0.5), eager=True)
    params, opt = init(scene, sky)
    eager = [float(step(params, opt, scene, sky, target, k)[2]) for k in range(3)]
    assert losses[0] == eager[0] and losses[2] < losses[0] and len(seen) == 3
    assert not torch.equal(seen[0], seen[2])
