"""The port's static-prefix ladder and second split of phase B (the JAX
package's `ops/mega.py:454-691`, its default forward on its chip) on the
CPU, as tests/test_mega.py::test_mega_nested_split_matches_unsplit holds
JAX's: the controlled scene at 64x64, 1 spp, depth 6.

- POCA_MEGA_LADDER=1 POCA_MEGA_SPLIT2=1 against the unsplit trace
  (POCA_MEGA_SPLIT=0): the traced paths (hit planes, first-hit normals
  and t, missed) bitwise equal, radiance within 5e-7 (its float32 sum
  runs in another order);
- POCA_MEGA_PREFIX2=1 (stage 2 over half the quarter, plus a spill
  launch) bitwise equal to the second split;
- the port against the JAX package under the same switches, at
  tests/test_torch_render.py's tolerances for the controlled scene.

Inputs come from numpy seeds and reach the port through convert.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.ops import mega
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda import compact_kernel, mega_kernel
from cpppathtracer_tpu_torch.ops.fast import group_scene

from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

W = H = 64
DEPTH = 6
SEED = 3
SKY = procedural_sky(8, 8)
SWITCHES = ("POCA_MEGA_SPLIT", "POCA_MEGA_LADDER", "POCA_MEGA_SPLIT2", "POCA_MEGA_PREFIX2")


def _jcam():
    return JCamera.make(W, H, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))


def _set(monkeypatch, **values):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in values.items():
        monkeypatch.setenv(k, v)


def _port(monkeypatch, calls=None, **switches):
    """One sample through mega_sample (its planes) and the render, under
    `switches`; with `calls`, the (kind, lanes) of every kernel-wrapper
    call the forward makes."""
    _set(monkeypatch, **switches)
    scene, cam = port_scene(controlled_scene()), port_camera(_jcam())
    if calls is not None:
        for name, fn in (("mega_trace", mega_kernel.mega_trace_plain),
                         ("stream_compact", compact_kernel.stream_compact_plain),
                         ("stream_expand", compact_kernel.stream_expand_plain)):
            def counted(*a, _n=name, _f=fn, **kw):
                calls.append((_n, a[2].shape[0] if _n == "mega_trace" else a[0].shape[0]))
                return _f(*a, **kw)
            monkeypatch.setattr(mega, name, counted)
    pix = torch.arange(W * H, dtype=torch.int32)
    sample = mega.mega_sample(group_scene(scene), cam, pix, 0, SEED, DEPTH, with_aux=True)
    rad = render_radiance(scene, cam, port_sky(SKY), spp=1, max_depth=DEPTH, seed=SEED)
    return sample, rad


def _paths(sample):
    """The planes that carry the traced paths: hits, missed, first_n, first_t."""
    return [*sample[6], sample[3], *sample[4], sample[5]]


def test_ladder_plan_follows_jax():
    """The plan at the test's size and the main path's: JAX's quarter
    prefix; the second split only with four bounces past the split;
    PREFIX2's half of the quarter in whole kernel blocks; the ladder off
    by default on the CPU (JAX's interpret default)."""
    assert mega._split_plan(W * H, DEPTH) == 2
    assert mega._ladder_plan(W * H, DEPTH, 2, "cpu") == (0, False, 0)
    with pytest.MonkeyPatch.context() as mp:
        _set(mp, POCA_MEGA_LADDER="1")
        assert mega._ladder_plan(W * H, DEPTH, 2, "cpu") == (1024, True, 1024)
        assert mega._ladder_plan(W * H, 5, 2, "cpu") == (1024, False, 1024)
        assert mega._ladder_plan(1 << 20, 8, 2, "cpu") == (1 << 18, True, 1 << 18)
        _set(mp, POCA_MEGA_LADDER="1", POCA_MEGA_PREFIX2="1")
        assert mega._ladder_plan(W * H, DEPTH, 2, "cpu") == (1024, True, 512)
        assert mega._ladder_plan(1 << 20, 8, 2, "cpu") == (1 << 18, True, 1 << 17)
        _set(mp, POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="0")
        assert mega._ladder_plan(W * H, DEPTH, 2, "cpu") == (1024, False, 1024)
        _set(mp, POCA_MEGA_SPLIT="0")
        assert mega._split_plan(W * H, DEPTH) == 0


def test_split2_matches_unsplit(monkeypatch):
    """POCA_MEGA_LADDER=1 POCA_MEGA_SPLIT2=1 against POCA_MEGA_SPLIT=0:
    paths bitwise, radiance (the sample's and the render's) within 5e-7,
    the aux planes bitwise on every bounce that hit.  The ladder ran: four
    mega_trace calls (phase A, B1's two stages, B2), two compactions."""
    s0, r0 = _port(monkeypatch, POCA_MEGA_SPLIT="0")
    calls = []
    s1, r1 = _port(monkeypatch, calls, POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1")
    kinds = [k for k, _ in calls[:8]]
    assert kinds.count("mega_trace") == 4 and kinds.count("stream_compact") == 2, calls
    assert ("mega_trace", 1024) in calls and ("mega_trace", 3072) in calls
    assert (s1[3] == 0).float().mean() < 0.9  # some paths survive the split
    for a, b in zip(_paths(s1), _paths(s0)):
        assert torch.equal(a, b)
    for k in range(3):
        np.testing.assert_allclose(s1[0][k].numpy(), s0[0][k].numpy(), rtol=5e-7, atol=5e-7)
    for b, ((p1, a1), (p0, a0)) in enumerate(zip(s1[7], s0[7])):
        hit = s0[6][b] >= 0
        for x, y in zip((*p1, a1), (*p0, a0)):
            assert torch.equal(x[hit], y[hit])
    np.testing.assert_allclose(r1[0].numpy(), r0[0].numpy(), rtol=5e-7, atol=5e-7)
    assert torch.equal(r1[1], r0[1]) and torch.equal(r1[2], r0[2])


def test_prefix2_matches_split2(monkeypatch):
    """POCA_MEGA_PREFIX2=1: stage 2 over the first 512 re-packed lanes of
    the quarter and a spill launch over the other 512, bitwise equal to
    the second split over the whole quarter (every plane of the sample,
    and the render)."""
    s1, r1 = _port(monkeypatch, POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1")
    calls = []
    s2, r2 = _port(monkeypatch, calls, POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1",
                   POCA_MEGA_PREFIX2="1")
    assert [c for c in calls[:8] if c == ("mega_trace", 512)] == [("mega_trace", 512)] * 2
    flat = lambda s: [*s[0], *s[1], *s[2], *_paths(s), *[c for p, a in s[7] for c in (*p, a)]]
    for a, b in zip(flat(s2), flat(s1)):
        assert torch.equal(a, b)
    for a, b in zip(r2, r1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("switches", [dict(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1"),
                                      dict(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1",
                                           POCA_MEGA_PREFIX2="1")],
                         ids=["split2", "prefix2"])
def test_split2_matches_jax(monkeypatch, switches):
    """The port against the JAX package's megakernel path (Pallas in
    interpret mode) under the same switches: at least 95% of the pixels
    within 5e-5 and first-hit t within 5e-5 relative on every pixel
    (tests/test_torch_render.py's rules for the controlled scene; measured
    98.6%); normals within 5e-5 on at least 99.5% of the pixels and 5e-4 on
    all (measured 99.78% and 1.24e-4: at 64x64 a few primaries graze a
    cylinder's rim, where the packages' roundings part; the same shares
    hold with no switch set, since the first hit is phase A's).  No kernel
    launches on the CPU."""
    _set(monkeypatch, POCA_MEGA="1", **switches)
    ref = [np.asarray(a) for a in j_render_radiance(controlled_scene(), _jcam(), jnp.asarray(SKY),
                                                    spp=1, max_depth=DEPTH, seed=SEED)]
    kb.reset_launches()
    got = [a.numpy() for a in _port(monkeypatch, **switches)[1]]
    assert not any(kb.LAUNCHES.values())
    close = np.isclose(got[0], ref[0], rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-5)
    n_close = np.isclose(got[1], ref[1], rtol=0, atol=5e-5).all(-1)
    assert n_close.mean() >= 0.995, n_close.mean()
    np.testing.assert_allclose(got[1], ref[1], atol=5e-4)
