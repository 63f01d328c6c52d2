"""The plain versions of the port's kernels against the JAX package's
Pallas kernels, in interpret mode as its own tests run them on the CPU.
(tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on a card.)"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import demo_scene as j_demo_scene
from cpppathtracer_tpu.ops import fast as j_fast
from cpppathtracer_tpu.ops.pallas import compact_kernel as j_compact
from cpppathtracer_tpu.ops.pallas.intersect_kernel import build_geom_mxu, build_geom_rows as j_geom_rows
from cpppathtracer_tpu.ops.pallas.mega_kernel import build_tables_T as j_tables_T, pallas_mega_trace
from cpppathtracer_tpu_torch.ops import planar
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda.compact_kernel import (
    stream_compact,
    stream_compact_plain,
    stream_expand,
    stream_expand_plain,
)
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows
from cpppathtracer_tpu_torch.ops.cuda.mega_kernel import build_tables_T, mega_trace, mega_trace_plain
from cpppathtracer_tpu_torch.ops.fast import group_scene

from torch_port_helpers import port_scene

torch.set_num_threads(1)

R = 2048
DEPTH = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays(seed, origin=(130.0, 103.0, 130.0), box=150.0):
    """Half the lanes are primaries of a camera looking at the scene's
    centre, half random rays from above the floor in a box of half-width
    `box`, all on the demo scene."""
    rng = np.random.RandomState(seed)
    cam = JCamera.make(256, 256, origin=origin, look_at=(0.0, 0.0, 0.0))
    pix = rng.choice(256 * 256, R // 2, replace=False).astype(np.int32)
    o_c, d_c = cam.ray_gen_planar(jnp.asarray(pix), 0, 0)
    o_r = np.stack([rng.uniform(-box, box, R // 2), rng.uniform(0.5, 40, R // 2),
                    rng.uniform(-box, box, R // 2)]).astype(np.float32)
    d_r = rng.normal(size=(3, R // 2)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=0)
    o = np.concatenate([np.stack([np.asarray(c) for c in o_c]), o_r], axis=1)
    d = np.concatenate([np.stack([np.asarray(c) for c in d_c]), d_r.astype(np.float32)], axis=1)
    pixel = np.concatenate([pix, rng.randint(0, 2**20, R // 2).astype(np.int32)])
    sample = rng.randint(0, 64, R).astype(np.int32)
    return o.astype(np.float32), d.astype(np.float32), pixel, sample


@pytest.fixture(scope="module")
def demo_tables():
    jscene = j_demo_scene(seed=0).build()
    jgs = j_fast.group_scene(jscene)
    gs = group_scene(port_scene(jscene))
    return jgs, gs


def _flat(out):
    """The 14 float planes of a trace's outputs, in kernel order."""
    return [*out[0], *out[1], *out[2], out[3], *out[4], out[5]]


def _compare_outputs(got, ref, lanes):
    """Every float output on `lanes`: at least 99% of them within 5e-5,
    all within 5e-3.  The quadratics lose digits to cancellation when the
    ray starts far from the object (|o| ~ 200 for the bench camera): a
    1-ulp difference in an input moves t by ~1e-6 relative, the hit point
    by ~1e-4 and a small sphere's normal, hence the sampled direction, by
    up to ~1e-3 (measured 1.3e-3 on 0.5% of the primaries)."""
    for k, (g, r) in enumerate(zip(_flat(got), _flat(ref))):
        g = g.numpy()[lanes]
        r = np.asarray(r)[lanes]
        close = np.isclose(g, r, rtol=5e-5, atol=5e-5)
        assert close.mean() >= 0.99, (k, close.mean())
        np.testing.assert_allclose(g, r, rtol=5e-3, atol=5e-3, err_msg=f"output {k}")


def _attrs_t(gs, idx, o, d, tmin):
    """t of each lane's ray against object `idx` (INF where idx < 0)."""
    rec = gs.table_s[torch.clamp(idx, min=0).long()].T
    t, _ = planar.object_hit_attrs_p(
        rec[6].to(torch.int32), (rec[0], rec[1], rec[2]), rec[3], rec[4], rec[5],
        o, d, tmin, torch.full_like(tmin, 1e30),
    )
    return torch.where(idx >= 0, t, torch.full_like(t, 1e30)).numpy()


def _pallas(jgs, o, d, pix, samp, seed, depth, **kw):
    conv = lambda a: tuple(jnp.asarray(c) for c in a) if isinstance(a, (tuple, np.ndarray)) and np.ndim(a) == 2 else a
    kw = {k: (tuple(jnp.asarray(c) for c in v) if k == "thru" else
              jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return pallas_mega_trace(
        conv(o), conv(d), jnp.asarray(pix), jnp.asarray(samp), seed, j_geom_rows(jgs),
        build_geom_mxu(jgs), *j_tables_T(jgs), counts=jgs.counts, depth=depth, tile=1024,
        interpret=True, **kw,
    )


def _plain(gs, o, d, pix, samp, seed, depth, **kw):
    ts, trt = build_tables_T(gs)
    kw = {k: (tuple(_t(c) for c in v) if k == "thru" else
              _t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    if "n_alive" in kw:
        kw["n_alive"] = torch.tensor([kw["n_alive"]], dtype=torch.int32)
    return mega_trace_plain(
        tuple(_t(c) for c in o), tuple(_t(c) for c in d), _t(pix), _t(samp), seed,
        build_geom_rows(gs), ts, trt, counts=gs.counts, depth=depth, **kw,
    )


def _hits(out):
    return np.stack([np.asarray(h) for h in out[6]])


def test_mega_trace_primaries_match_pallas(demo_tables):
    """Primary rays of the bench camera, one bounce: the winner search and
    the bounce body.  Hit planes differ on at most 0.5% of lanes, and only
    where the two winners are t-ties within 1e-5 relative (a cylinder's
    bottom cap lies in the floor's plane; the Pallas kernel's MXU form
    rounds the tie the other way).  Outputs as `_compare_outputs` holds
    them elsewhere."""
    jgs, gs = demo_tables
    rng = np.random.RandomState(1)
    cam = JCamera.make(512, 512, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
    pix = rng.choice(512 * 512, R, replace=False).astype(np.int32)
    o_j, d_j = cam.ray_gen_planar(jnp.asarray(pix), 0, 0)
    o = np.stack([np.asarray(c) for c in o_j])
    d = np.stack([np.asarray(c) for c in d_j])
    samp = rng.randint(0, 64, R).astype(np.int32)
    ref = _pallas(jgs, o, d, pix, samp, 5, 1)
    got = _plain(gs, o, d, pix, samp, 5, 1)
    hg, hr = _hits(got)[0], _hits(ref)[0]
    assert (hg >= 0).mean() > 0.5
    differ = hg != hr
    assert differ.mean() <= 0.005, differ.sum()
    tmin = torch.zeros(R)
    ray = (tuple(_t(c) for c in o), tuple(_t(c) for c in d))
    t_g = _attrs_t(gs, torch.from_numpy(hg), *ray, tmin)[differ]
    t_r = _attrs_t(gs, torch.from_numpy(hr.copy()), *ray, tmin)[differ]
    np.testing.assert_allclose(t_g, t_r, rtol=1e-5)
    _compare_outputs(got, ref, ~differ)


@pytest.mark.parametrize("camera", [((130.0, 103.0, 130.0), 150.0), ((40.0, 25.0, 40.0), 50.0)],
                         ids=["bench_camera", "near_camera"])
def test_mega_trace_lockstep_matches_pallas(demo_tables, camera):
    """Bounces 0-3 in lockstep: each bounce starts both kernels from the
    Pallas kernel's own state after the previous one, in the phase-B form
    (start_bounce, thru, n_alive, alive_mask), so that float32 rounding
    differences cannot compound along a path.

    Secondary rays start on a surface, and whether a ray re-hits the
    surface it leaves depends on where its rounded origin lies: the
    winner search's t carries a rounding error of order ulp(|o|^2)/|o|,
    which at the demo scene's coordinates (up to 550) exceeds
    BOUNCE_RAY_TMIN = 2e-5.  XLA's CPU arithmetic (FMA contraction, its
    own sqrt and transcendentals) rounds differently from PyTorch's, so
    some of those decisions flip: at most 8% of the live lanes per
    secondary bounce here (measured 0.6-7.8%).  Primaries keep the 0.5%
    bound.  Every lane that differs has one of four causes, each a
    decision that float32 rounding makes: a t-tie within 1e-5 relative (a
    cylinder's bottom cap in the floor's plane), a winner within 0.05 of
    the origin (a re-hit of the surface the ray leaves, or the 0.01-thick
    shell of a hollow glass object), a winner that the exact hit test then
    misses (-1: the search's quadratic cancels, the epilogue's does not),
    or a glass winner (the demo scene nests a sphere in each hollow glass
    object, sharing its centre).  Lanes that agree match as
    `_compare_outputs` holds them, and inactive lanes publish neutral
    outputs."""
    jgs, gs = demo_tables
    o, d, pix, samp = _rays(1, *camera)
    thru = np.ones((3, R), np.float32)
    missed = np.zeros(R, np.float32)
    n_alive = R - 100
    glass = gs.table_s[:, 7].numpy() == 3
    for b in range(DEPTH):
        kw = dict(start_bounce=b, thru=thru, n_alive=n_alive, alive_mask=missed)
        ref = _pallas(jgs, o, d, pix, samp, 5, 1, with_o=True, **kw)
        got = _plain(gs, o, d, pix, samp, 5, 1, with_o=True, **kw)
        active = (np.arange(R) < n_alive) & (missed == 0)
        hg, hr = _hits(got)[0], _hits(ref)[0]
        agree = (hg == hr) & active
        bound = 0.005 if b == 0 else 0.08
        assert agree.sum() >= (1 - bound) * active.sum(), (b, agree.sum(), active.sum())
        _compare_outputs(got, ref, agree)
        differ = active & ~agree
        ray = (tuple(_t(c) for c in o), tuple(_t(c) for c in d))
        tmin = torch.full((R,), 0.0 if b == 0 else 2e-5)
        t_g = _attrs_t(gs, torch.from_numpy(hg.copy()), *ray, tmin)
        t_r = _attrs_t(gs, torch.from_numpy(hr.copy()), *ray, tmin)
        explained = (
            (np.isclose(t_g, t_r, rtol=1e-5) & (t_g < 1e30))
            | (np.minimum(t_g, t_r) < 0.05)
            | (hg < 0) | (hr < 0)
            | glass[np.maximum(hg, 0)] | glass[np.maximum(hr, 0)]
        )
        assert explained[differ].all(), (b, np.where(differ & ~explained)[0])
        for plane in _flat(got):
            assert (plane.numpy()[~active] == 0).all()
        assert (hg[~active] == -1).all()
        o = np.stack([np.asarray(c) for c in ref[8]])
        d = np.stack([np.asarray(c) for c in ref[1]])
        thru = np.stack([np.asarray(c) for c in ref[2]])
        missed = np.maximum(missed, np.asarray(ref[3]))


@pytest.mark.parametrize("phase_b", [False, True], ids=["unguarded", "guarded"])
def test_mega_trace_chained_matches_pallas(demo_tables, phase_b):
    """Depth 4 chained in one call, unguarded, and the phase-B form
    (start_bounce=2, thru, n_alive, alive_mask).  Along a whole path the
    surface re-hit decisions above compound, so at least 93% of the live
    lanes trace identical paths (measured 94.8% and up), and those match
    as `_compare_outputs` holds them."""
    jgs, gs = demo_tables
    o, d, pix, samp = _rays(2)
    kw = {}
    active = np.ones(R, bool)
    if phase_b:
        rng = np.random.RandomState(3)
        amask = (rng.uniform(size=R) < 0.2).astype(np.float32)
        kw = dict(start_bounce=2, thru=rng.uniform(0.1, 1.0, (3, R)).astype(np.float32),
                  n_alive=1500, alive_mask=amask)
        active = (np.arange(R) < 1500) & (amask == 0)
    ref = _pallas(jgs, o, d, pix, samp, 9, DEPTH, **kw)
    got = _plain(gs, o, d, pix, samp, 9, DEPTH, **kw)
    agree = (_hits(got) == _hits(ref)).all(axis=0) & active
    assert agree.sum() >= 0.93 * active.sum(), (agree.sum(), active.sum())
    _compare_outputs(got, ref, agree)


def test_mega_trace_wrapper_takes_plain_on_cpu(demo_tables):
    """On CPU tensors the wrapper is the plain version and counts nothing."""
    _, gs = demo_tables
    o, d, pix, samp = _rays(4)
    ts, trt = build_tables_T(gs)
    args = (tuple(_t(c) for c in o[:, :256]), tuple(_t(c) for c in d[:, :256]),
            _t(pix[:256]), _t(samp[:256]), 1, build_geom_rows(gs), ts, trt)
    kb.reset_launches()
    a = mega_trace(*args, counts=gs.counts, depth=2)
    b = mega_trace_plain(*args, counts=gs.counts, depth=2)
    assert kb.LAUNCHES["mega_trace"] == 0
    for x, y in zip(a[6], b[6]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    with pytest.raises(NotImplementedError):
        mega_trace(*args, counts=gs.counts, depth=2, with_aux=True)


# --------------------------------------------------------------- compaction

CHUNK = 1024


def _compact_inputs(seed, r=4 * CHUNK):
    rng = np.random.RandomState(seed)
    missed = (rng.uniform(size=r) > 0.2).astype(np.float32)  # ~20% alive
    f = rng.normal(size=(3, r)).astype(np.float32)
    i = rng.randint(-1000, 1000, (2, r)).astype(np.int32)
    return missed, f, i


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_compact_plain_matches_pallas(seed):
    """Packed order and alive-lane values equal the Pallas kernel's stream
    (its 128-lane bubbles are not part of the contract, so the stream is
    read segment by segment)."""
    missed, f, i = _compact_inputs(seed)
    r = missed.shape[0]
    planes_j = (jnp.asarray(i[0]), jnp.asarray(f[0]), jnp.asarray(f[1]), jnp.asarray(i[1]), jnp.asarray(f[2]))
    comp, offs, _ = j_compact.stream_compact(
        jnp.asarray(missed), planes_j, fills=(0,) * 5, chunk=CHUNK, interpret=True
    )
    comp, offs = np.asarray(comp), np.asarray(offs)
    seg = []
    for k in range(r // CHUNK):
        cnt = int((missed[k * CHUNK:(k + 1) * CHUNK] == 0).sum())
        seg.append(comp[:, offs[k] * 128: offs[k] * 128 + cnt])
    seg = np.concatenate(seg, axis=1)
    planes_t = [_t(i[0]), _t(f[0]), _t(f[1]), _t(i[1]), _t(f[2])]
    packed, pos, n_alive = stream_compact_plain(_t(missed), planes_t, [-1, 0.0, 0.0, -1, 0.0])
    n = int(n_alive[0])
    assert n == seg.shape[1] == int((missed == 0).sum())
    for p in range(5):
        np.testing.assert_array_equal(packed[p].numpy().view(np.int32)[:n], seg[p])
    # the Pallas local-position plane, made global, is the port's pos
    chunk_of = np.concatenate([np.full(int((missed[k * CHUNK:(k + 1) * CHUNK] == 0).sum()), k)
                               for k in range(r // CHUNK)])
    np.testing.assert_array_equal(pos.numpy()[:n], seg[5] + chunk_of * CHUNK)
    assert (pos.numpy()[n:] == -1).all() and (packed[0].numpy()[n:] == -1).all()


def test_stream_expand_plain_matches_pallas():
    """expand(compact(x)) equals x on alive lanes and the fills elsewhere,
    for both packages."""
    missed, f, i = _compact_inputs(7)
    planes_j = (jnp.asarray(f[0]), jnp.asarray(i[0]))
    comp, offs, _ = j_compact.stream_compact(
        jnp.asarray(missed), planes_j, fills=(0, 0), chunk=CHUNK, interpret=True
    )
    ref = j_compact.stream_expand(
        jnp.asarray(missed), comp, offs, dtypes=(jnp.float32, jnp.int32),
        fills=(0, -5), chunk=CHUNK, interpret=True,
    )
    packed, pos, n_alive = stream_compact_plain(_t(missed), [_t(f[0]), _t(i[0])], [0.0, 0])
    got = stream_expand_plain(_t(missed), pos, packed, [0.0, -5], n_alive)
    alive = missed == 0
    for g, r, x in zip(got, ref, (f[0], i[0])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy()[alive], x[alive])
    assert (got[1].numpy()[~alive] == -5).all()


def test_compaction_wrappers_take_plain_on_cpu():
    missed, f, i = _compact_inputs(9, r=1000)
    kb.reset_launches()
    packed, pos, n_alive = stream_compact(_t(missed), [_t(f[0])], [0.0])
    back = stream_expand(_t(missed), pos, packed, [0.0], n_alive)
    assert kb.LAUNCHES["stream_compact"] == kb.LAUNCHES["stream_expand"] == 0
    np.testing.assert_array_equal(back[0].numpy()[missed == 0], f[0][missed == 0])
