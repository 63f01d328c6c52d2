"""The port's BVH against the JAX package: the skip-pointer tables, refit,
the walk's plain version against the Pallas kernel in interpret mode (and
against the dense winner), the walk of csrc/bvh.cuh built for the host,
and the wavefront path's hit record.  tests/test_torch_cuda.py holds the
CUDA kernels against the plain versions on a card."""

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
from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import bvh_winner_index, bvh_winner_index_plain
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
    build_geom_rows,
    winner_index,
    winner_index_plain,
)
from cpppathtracer_tpu_torch.types import INF

from torch_port_helpers import port_scene

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
    for g, r in ((got_moved.refit_bvh(), ref_moved.refit_bvh()),
                 (got.with_geometry(center=_t(center)), ref.with_geometry(center=jnp.asarray(center)))):
        assert not g.bvh_is_stale()
        for k in TABLES:
            assert np.array_equal(getattr(g, k).numpy(), np.asarray(getattr(r, k))), k


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
    gs = fast.group_scene(port_scene(jscene))
    ray = (tuple(_t(o[:, i]) for i in range(3)), tuple(_t(d[:, i]) for i in range(3)),
           torch.zeros(r), torch.full((r,), INF))
    return dict(name=request.param, gs=gs, ray=ray, hits=t_dense < 1e29, i_dense=i_dense,
                i_bvh=i_bvh, k=k)


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
    so.poca_bvh_winner_host.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
    so.poca_bvh_winner_host.restype = ctypes.c_int

    def run(o, d, tmin, tmax, meta, aabb, objs, k):
        r = tmin.shape[0]
        out = torch.empty(r, dtype=torch.int32)
        nodes = torch.empty(r, dtype=torch.int32)
        rows = torch.empty((4, r), dtype=torch.int32)
        ptrs = [t.data_ptr() for t in (*o, *d, tmin, tmax, meta, aabb, objs, out, nodes, rows)]
        assert so.poca_bvh_winner_host(*ptrs, r, meta.shape[0], k) == 0
        return out, nodes, rows

    return run


def test_bvh_walk_host_build_matches_plain(case, host_walk):
    """The kernel's walk, compiled for the host, equals the plain version
    bitwise: indices, slab tests and leaf rows by type, lane by lane."""
    gs = case["gs"]
    got = host_walk(*case["ray"], gs.bvh_meta, gs.bvh_aabb, gs.bvh_objs, case["k"])
    ref = _plain(case, with_counts=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(ref[1].min()) >= 1 and int(ref[2].sum()) % case["k"] == 0


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
