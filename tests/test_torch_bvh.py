"""The port's BVH against the JAX package: the skip-pointer tables, refit,
the walk kernel's layout of them, the walk's plain version against the
Pallas kernel in interpret mode (and against the dense winner), the walk
of csrc/bvh.cuh built for the host, and the wavefront path's hit record.
tests/test_torch_cuda.py holds the CUDA kernels against the plain versions
on a card."""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpppathtracer_tpu.models import presets as jpresets
from cpppathtracer_tpu.ops import fast as j_fast
from cpppathtracer_tpu.ops.pallas.bvh_kernel import pallas_bvh_winner_index
from cpppathtracer_tpu.types import Rays
from cpppathtracer_tpu_torch.models import presets
from cpppathtracer_tpu_torch.ops import fast, planar
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.models.scene import SceneBuilder
from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import (
    bvh_leaf_layout,
    bvh_winner_index,
    bvh_winner_index_plain,
)
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
    build_geom_rows,
    winner_index,
    winner_index_plain,
)
from cpppathtracer_tpu_torch.types import INF

from torch_port_helpers import port_scene
from torch_scenes import tie_rays, tie_scene

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "cpppathtracer_tpu_torch" / "csrc"
TABLES = ("bvh_meta", "bvh_aabb", "bvh_objs")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("n,leaf_size", [(96, None), (220, None), (2064, None), (220, 8)],
                         ids=["96", "220", "2064", "220-leaf8"])
def test_bvh_tables_match_jax(n, leaf_size):
    """with_bvh's tables equal the JAX package's exactly, with K set
    automatically (big_scene(2064) gets them at build time) or given."""
    if leaf_size is None:
        ref = jpresets.big_scene(n, bvh=True)
        got = presets.big_scene(n, bvh=True, device="cpu")
    else:
        ref = jpresets.big_scene(n, bvh=False).with_bvh(leaf_size)
        got = presets.big_scene(n, bvh=False, device="cpu").with_bvh(leaf_size)
    assert got.bvh_dims == ref.bvh_dims
    for k in TABLES:
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k
    if n >= 2048:
        assert presets.big_scene(n, device="cpu").bvh_meta is not None


def test_refit_and_staleness_match_jax():
    """After a bare replace of the centres both packages see stale tables;
    refit_bvh and with_geometry give the JAX package's tables exactly."""
    ref = jpresets.big_scene(96, bvh=True)
    got = presets.big_scene(96, bvh=True, device="cpu")
    rng = np.random.RandomState(5)
    center = np.asarray(ref.center) + rng.uniform(-5, 5, ref.center.shape).astype(np.float32)
    ref_moved = dataclasses.replace(ref, center=jnp.asarray(center))
    got_moved = dataclasses.replace(got, center=_t(center))
    assert got_moved.bvh_is_stale() and ref_moved.bvh_is_stale()
    assert not got.bvh_is_stale()
    old_rows = got.bvh_layout[2]
    for g, r in ((got_moved.refit_bvh(), ref_moved.refit_bvh()),
                 (got.with_geometry(center=_t(center)), ref.with_geometry(center=jnp.asarray(center)))):
        assert not g.bvh_is_stale()
        for k in TABLES:
            assert np.array_equal(getattr(g, k).numpy(), np.asarray(getattr(r, k))), k
        # the walk kernel's layout is rebuilt from the refitted tables
        _check_scene_layout(g)
        assert not torch.equal(g.bvh_layout[2], old_rows)


def _check_scene_layout(scene):
    """The layout a scene carries is bvh_leaf_layout of its tables, bit for
    bit (leaf id -1 is a NaN as a float), and the grouping hands it on."""
    tables = (scene.bvh_meta, scene.bvh_aabb, scene.bvh_objs)
    for a, b in zip(scene.bvh_layout, bvh_leaf_layout(*tables, scene.bvh_dims[1])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert fast.group_scene(scene).bvh_layout is scene.bvh_layout


@pytest.mark.parametrize("n,leaf_size", [(220, None), (2064, None), (220, 8)],
                         ids=["220", "2064", "220-leaf8"])
def test_bvh_leaf_layout(n, leaf_size):
    """The walk kernel's layout: nodes carry the boxes and meta as they
    are; each leaf's rows are its non-padding rows of leaf_objs, spheres,
    then cylinders, then platforms, each type in table order, in 16-byte
    words with their grouped indices beside; the headers count them."""
    scene = presets.big_scene(n, bvh=leaf_size is None, device="cpu")
    if leaf_size is not None:
        scene = scene.with_bvh(leaf_size)
    m, k = scene.bvh_dims
    nodes, leaves, rows, gidx = bvh_leaf_layout(scene.bvh_meta, scene.bvh_aabb, scene.bvh_objs, k)
    assert torch.equal(nodes[:, [0, 1, 2, 4, 5, 6]], scene.bvh_aabb[:, :6])
    assert torch.equal(nodes[:, [3, 7]].contiguous().view(torch.int32), scene.bvh_meta)
    objs = scene.bvh_objs.reshape(-1, k, 8)
    assert leaves.shape == (objs.shape[0], 4) and leaves.dtype == torch.int32
    words = leaves[:, 1] + 2 * leaves[:, 2] + leaves[:, 3]
    assert int(leaves[0, 0]) == 0 and rows.shape == (int(words.sum()), 4)
    assert torch.equal(leaves[1:, 0], torch.cumsum(words, 0)[:-1].to(torch.int32))
    assert int((scene.bvh_objs[:, 6] >= 0).sum()) == int(leaves[:, 1:].sum())
    zero = torch.zeros(3)
    for leaf, (first, n_s, n_c, n_p) in enumerate(leaves.tolist()):
        src = objs[leaf]
        assert (n_s, n_c, n_p) == tuple(int((src[:, 6] == t).sum()) for t in (0, 2, 1))
        sph, cyl, plat = (src[src[:, 6] == t] for t in (0, 2, 1))
        q = first
        for row in sph:
            assert torch.equal(rows[q], row[0:4]) and int(gidx[q]) == int(row[7])
            q += 1
        for row in cyl:
            assert torch.equal(rows[q], row[0:4]) and int(gidx[q]) == int(row[7])
            assert float(rows[q + 1, 0]) == float(row[5]) and torch.equal(rows[q + 1, 1:], zero)
            q += 2
        for row in plat:
            assert float(rows[q, 0]) == float(row[4]) and torch.equal(rows[q, 1:], zero)
            assert int(gidx[q]) == int(row[7])
            q += 1


# ------------------------------------------------------------------- rays


def _random_rays():
    """tests/test_bvh.py's 512 random rays over big_scene(200)."""
    rng = np.random.RandomState(3)
    r = 512
    o = rng.uniform(-120, 120, (r, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(2, 60, r)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return 200, o, d.astype(np.float32)


def _camera_rays():
    """The primaries of big_camera(220, 24, 16), sample 0."""
    cam = jpresets.big_camera(220, 24, 16)
    o, d = cam.ray_gen_planar(jnp.arange(24 * 16, dtype=jnp.int32), 0, 0)
    return 220, np.stack([np.asarray(c) for c in o], 1), np.stack([np.asarray(c) for c in d], 1)


def _axis_rays():
    """256 rays over big_scene(200) each with one or two direction
    components exactly zero, among them straight down and level rays."""
    rng = np.random.RandomState(11)
    r = 256
    o = rng.uniform(-120, 120, (r, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 30, r)
    d = rng.normal(size=(r, 3))
    for i, zero in enumerate(([0], [1], [2], [0, 2], [0, 1], [1, 2])):
        d[i::6, zero] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return 200, o, d.astype(np.float32)


RAYS = {"random": _random_rays, "camera": _camera_rays, "zero-components": _axis_rays}


@pytest.fixture(scope="module", params=list(RAYS))
def case(request):
    """A BVH scene in both packages and a ray set on it, with the JAX
    package's dense and Pallas BVH winners."""
    n, o, d = RAYS[request.param]()
    jscene = jpresets.big_scene(n, bvh=True)
    jgs = j_fast.group_scene(jscene)
    r = o.shape[0]
    rays = Rays.make(o, d)
    t_dense, i_dense = (np.asarray(a) for a in j_fast._winner_grouped_T(jgs, rays))
    m, k = jscene.bvh_dims
    i_bvh = np.asarray(pallas_bvh_winner_index(
        tuple(jnp.asarray(o[:, i]) for i in range(3)), tuple(jnp.asarray(d[:, i]) for i in range(3)),
        rays.tmin, rays.tmax, jscene.bvh_meta, jscene.bvh_aabb, jscene.bvh_objs,
        m=m, k=k, tile=128, interpret=True,
    ))
    scene = port_scene(jscene)
    ray = (tuple(_t(o[:, i]) for i in range(3)), tuple(_t(d[:, i]) for i in range(3)),
           torch.zeros(r), torch.full((r,), INF))
    return dict(name=request.param, scene=scene, gs=fast.group_scene(scene), ray=ray,
                hits=t_dense < 1e29, i_dense=i_dense, i_bvh=i_bvh, k=k)


def _plain(case, **kw):
    gs = case["gs"]
    return bvh_winner_index_plain(*case["ray"], gs.bvh_meta, gs.bvh_aabb, gs.bvh_objs,
                                  leaf_size=case["k"], **kw)


def _near_tie_share(case, got, ref):
    """The share of hit lanes whose indices differ, asserting that each
    such lane is a near-tie: the two objects' t within 1e-5 relative."""
    gs = case["gs"]
    o, d, tmin, tmax = case["ray"]
    t_of = lambda idx: planar.gather_epilogue_p(gs.table_s, gs.table_r, o, d, tmin, tmax,
                                                _t(np.asarray(idx, np.int32)))[0]["t"]
    hits = case["hits"]
    diff = hits & (np.asarray(got) != np.asarray(ref))
    t_a, t_b = t_of(got).numpy()[diff], t_of(ref).numpy()[diff]
    assert np.all(np.abs(t_a - t_b) <= 1e-5 * np.maximum(np.abs(t_a), np.abs(t_b))), (t_a, t_b)
    return diff.sum() / diff.size


def test_bvh_walk_plain_matches_pallas(case):
    """The per-ray walk against the Pallas tile walk (interpret mode) and
    against the port's dense winner: equal indices on every lane where the
    dense winner hits, except near-ties (t within 1e-5 relative) on at
    most 0.1% of the lanes."""
    got = _plain(case).numpy()
    hits = case["hits"]
    assert hits.sum() > hits.size // 4
    share = _near_tie_share(case, got, case["i_bvh"])
    gs = case["gs"]
    dense = winner_index_plain(gs.counts, *case["ray"], build_geom_rows(gs)).numpy()
    share_dense = _near_tie_share(case, got, dense)
    print(f"{case['name']}: {hits.sum()} hit lanes of {hits.size}; indices differ on "
          f"{share:.4%} (Pallas walk) and {share_dense:.4%} (port's dense winner)")
    assert share <= 1e-3 and share_dense <= 1e-3
    assert np.array_equal(dense[hits], case["i_dense"][hits])
    assert np.all(got[~hits] == 0)


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """csrc/bvh.cuh's walk built for the host by g++ (tests/bvh_host.cpp)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the BVH walk for the host")
    lib = tmp_path_factory.mktemp("bvh_host") / "libbvh_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(CSRC), str(TESTS / "bvh_host.cpp"), "-o", str(lib)], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.poca_bvh_winner_host.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 2
    so.poca_bvh_winner_host.restype = ctypes.c_int

    def run(o, d, tmin, tmax, layout):
        r = tmin.shape[0]
        out = torch.empty(r, dtype=torch.int32)
        nodes = torch.empty(r, dtype=torch.int32)
        rows = torch.empty((3, r), dtype=torch.int32)
        ptrs = [t.data_ptr() for t in (*o, *d, tmin, tmax, *layout, out, nodes, rows)]
        assert so.poca_bvh_winner_host(*ptrs, r, layout[0].shape[0]) == 0
        return out, nodes, rows

    return run


def _check_host_walk(got, ref, k):
    """The host build's indices, slab tests and sphere / platform /
    cylinder rows equal the plain version's lane by lane (the plain
    version also counts padding rows: K rows a leaf)."""
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(got[2], ref[2][:3])
    assert int(ref[1].min()) >= 1 and int(ref[2].sum()) % k == 0


def test_scene_carries_bvh_layout(case):
    """A scene carried across from the JAX package carries the walk
    kernel's layout of its tables."""
    _check_scene_layout(case["scene"])


def test_bvh_walk_host_build_matches_plain(case, host_walk):
    """The kernel's walk over the scene's grouped layout, compiled for the
    host, equals the plain version on the JAX-equal tables bitwise:
    indices, slab tests and leaf rows by type, lane by lane."""
    gs = case["gs"]
    got = host_walk(*case["ray"], gs.bvh_layout)
    _check_host_walk(got, _plain(case, with_counts=True), case["k"])


def test_bvh_walk_host_build_exact_ties(host_walk):
    """Exact ties within a leaf (lowest grouped index) and across leaves
    (the leaf the walk reaches first): the host build of the grouped walk
    equals the plain version bitwise, and on some lanes both keep a tied
    object other than the lowest-indexed one."""
    gs = fast.group_scene(tie_scene())
    ray = tie_rays(2048)
    tables = (gs.bvh_meta, gs.bvh_aabb, gs.bvh_objs)
    k = gs.bvh_dims[1]
    got = host_walk(*ray, gs.bvh_layout)
    ref = bvh_winner_index_plain(*ray, *tables, leaf_size=k, with_counts=True)
    _check_host_walk(got, ref, k)
    # every object's t on every ray: the objects tied with the winner
    n = gs.table_s.shape[0]
    t_all = torch.stack([planar.gather_epilogue_p(gs.table_s, gs.table_r, *ray,
                                                  torch.full_like(ref[0], j))[0]["t"]
                         for j in range(n)])
    win = ref[0].long()
    t_win = t_all.gather(0, win[None])[0]
    hit = t_win < INF
    tied = (t_all == t_win[None]) & hit[None]
    lowest = torch.where(tied, torch.arange(n)[:, None], n).amin(0)
    n_tied = int((tied.sum(0) > 1).sum())
    later = hit & (win != lowest)
    print(f"{int(hit.sum())} of {win.numel()} lanes hit, {n_tied} of them on a tie, "
          f"{int(later.sum())} kept a tied object other than the lowest-indexed")
    assert int(hit.sum()) > win.numel() // 2 and n_tied > 100 and int(later.sum()) > 0


@pytest.mark.parametrize("bvh", ["1", "0"], ids=["bvh", "dense"])
def test_hit_record_matches_jax(monkeypatch, bvh):
    """fast.intersect_and_gather_planar in the port and in the JAX package
    (POCA_PALLAS=1: the Pallas kernels in interpret mode), BVH walk or
    dense winner, on the random and camera rays: the same winners, and the
    hit record within 1e-6."""
    monkeypatch.setenv("POCA_PALLAS", "1")
    monkeypatch.setenv("POCA_BVH", bvh)
    n, o, d = _camera_rays()
    o2, d2 = _random_rays()[1:]
    o, d = np.concatenate([o, o2[:128]]), np.concatenate([d, d2[:128]])
    r = o.shape[0]
    jscene = jpresets.big_scene(n, bvh=True)
    ref, ref_m = j_fast.intersect_and_gather_planar(
        j_fast.group_scene(jscene), tuple(jnp.asarray(o[:, i]) for i in range(3)),
        tuple(jnp.asarray(d[:, i]) for i in range(3)), jnp.zeros(r), jnp.full(r, INF, jnp.float32))
    got, got_m = fast.intersect_and_gather_planar(
        fast.group_scene(port_scene(jscene)), tuple(_t(o[:, i]) for i in range(3)),
        tuple(_t(d[:, i]) for i in range(3)), torch.zeros(r), torch.full((r,), INF))
    assert np.asarray(ref["hit"]).mean() > 0.5
    assert np.array_equal(got["obj_idx"].numpy(), np.asarray(ref["obj_idx"]))
    assert np.array_equal(got["hit"].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), rtol=1e-6)
    for key in ("pos", "normal"):
        for a, b in zip(got[key], ref[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for key in ("mat_type", "smoothness", "reflectivity", "ior", "emission"):
        assert np.array_equal(got_m[key].numpy(), np.asarray(ref_m[key])), key


def test_wrappers_take_plain_on_cpu():
    """On CPU tensors both winner launches are their plain versions and
    count no launch."""
    n, o, d = _random_rays()
    scene = presets.big_scene(n, bvh=True, device="cpu")
    gs = fast.group_scene(scene)
    r = o.shape[0]
    ray = (tuple(_t(o[:, i]) for i in range(3)), tuple(_t(d[:, i]) for i in range(3)),
           torch.zeros(r), torch.full((r,), INF))
    kb.reset_launches()
    tables = (gs.bvh_meta, gs.bvh_aabb, gs.bvh_objs)
    k = gs.bvh_dims[1]
    assert torch.equal(bvh_winner_index(*ray, *tables, leaf_size=k),
                       bvh_winner_index_plain(*ray, *tables, leaf_size=k))
    geom = build_geom_rows(gs)
    assert torch.equal(winner_index(gs.counts, *ray, geom), winner_index_plain(gs.counts, *ray, geom))
    assert kb.LAUNCHES["bvh_winner_index"] == kb.LAUNCHES["winner_index"] == 0
    with pytest.raises(ValueError):
        bvh_winner_index(*ray, *tables, leaf_size=k + 1)
