"""The port's phase B on the CPU: one launch over the packed lanes, held
against every phase-B schedule of the JAX package (its static-prefix
ladder, the second split inside it, POCA_MEGA_PREFIX2), and the split
bounce against JAX's rule.  The controlled scene at 64x64, 1 spp,
depth 6, as tests/test_mega.py::test_mega_nested_split_matches_unsplit
holds JAX's own schedules against each other.

Inputs come from numpy seeds and reach the port through convert.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.ops import mega as j_mega
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.ops import mega
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda import compact_kernel, mega_kernel

from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)

W = H = 64
DEPTH = 6
SEED = 3
SKY = procedural_sky(8, 8)
# the JAX package's phase-B switches, which the port does not read
SWITCHES = ("POCA_MEGA_SPLIT", "POCA_MEGA_TILE", "POCA_MEGA_COMPACT", "POCA_MEGA_LADDER",
            "POCA_MEGA_SPLIT2", "POCA_MEGA_PREFIX2")


def _jcam():
    return JCamera.make(W, H, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0))


def _set(monkeypatch, **values):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in values.items():
        monkeypatch.setenv(k, v)


SCHEDULES = {
    "ladder": dict(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="0"),
    "split2": dict(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1"),
    "prefix2": dict(POCA_MEGA_LADDER="1", POCA_MEGA_SPLIT2="1", POCA_MEGA_PREFIX2="1"),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_phase_b_matches_jax_schedules(monkeypatch, schedule):
    """The port's render, its phase B one launch (two mega_trace calls,
    phase A's and phase B's, one compaction), against the JAX package's
    megakernel path (Pallas in interpret mode) under each of its phase-B
    schedules: at least 95% of the pixels within 5e-5 and first-hit t
    within 5e-5 relative on every pixel (tests/test_torch_render.py's
    rules for the controlled scene); normals within 5e-5 on at least 99.5%
    of the pixels and 5e-4 on all (at 64x64 a few primaries graze a
    cylinder's rim, where the packages' roundings part).  The port renders
    under the same switches, which it does not read.  No kernel launches
    on the CPU."""
    _set(monkeypatch, POCA_MEGA="1", **SCHEDULES[schedule])
    ref = [np.asarray(a) for a in j_render_radiance(controlled_scene(), _jcam(), jnp.asarray(SKY),
                                                    spp=1, max_depth=DEPTH, seed=SEED)]
    calls = []
    for name, fn in (("mega_trace", mega_kernel.mega_trace_plain),
                     ("stream_compact", compact_kernel.stream_compact_plain)):
        def counted(*a, _n=name, _f=fn, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        monkeypatch.setattr(mega, name, counted)
    kb.reset_launches()
    scene, cam = port_scene(controlled_scene()), port_camera(_jcam())
    got = [a.numpy() for a in render_radiance(scene, cam, port_sky(SKY), spp=1,
                                               max_depth=DEPTH, seed=SEED)]
    assert not any(kb.LAUNCHES.values())
    assert (calls.count("mega_trace"), calls.count("stream_compact")) == (2, 1), calls
    close = np.isclose(got[0], ref[0], rtol=0, atol=5e-5).all(-1)
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-5)
    n_close = np.isclose(got[1], ref[1], rtol=0, atol=5e-5).all(-1)
    assert n_close.mean() >= 0.995, n_close.mean()
    np.testing.assert_allclose(got[1], ref[1], atol=5e-4)


@pytest.mark.parametrize("r, depth, split", [
    (64 * 64, 6, None), (64 * 64, 3, None), (32 * 16, 4, None), (64 * 64, 6, "0"),
    (64 * 64, 6, "3"),
], ids=["64x64-d6", "64x64-d3", "32x16-d4", "64x64-d6-split0", "64x64-d6-split3"])
def test_split_plan_follows_jax(monkeypatch, r, depth, split):
    """The split bounce is JAX's (`ops/mega.py::_split_plan`): its bounce
    where it compacts (a chunk), 0 for an unsplit trace."""
    _set(monkeypatch, **({} if split is None else {"POCA_MEGA_SPLIT": split}))
    j_split, chunk = j_mega._split_plan(r, depth)
    assert mega._split_plan(r, depth) == (j_split if chunk else 0)
