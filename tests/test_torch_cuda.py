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
from cpppathtracer_tpu_torch.models.scene import demo_scene
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


@pytest.mark.gpu
def test_compaction_matches_plain_on_card(dev):
    """stream_compact / stream_expand bitwise equal to their plain
    versions, and expand(compact(x)) == x on the alive lanes."""
    g = torch.Generator(device=dev).manual_seed(0)
    missed = (torch.rand(R + 17, device=dev, generator=g) > 0.2).float()
    planes = [torch.randn(R + 17, device=dev, generator=g),
              torch.randint(-1000, 1000, (R + 17,), dtype=torch.int32, device=dev, generator=g)]
    fills = [1.0, -1]
    kb.reset_launches()
    got = stream_compact(missed, planes, fills)
    ref = stream_compact_plain(missed, planes, fills)
    for a, b in zip([*got[0], got[1], got[2]], [*ref[0], ref[1], ref[2]]):
        assert torch.equal(a, b)
    back = stream_expand(missed, got[1], got[0], [0.0, 7], got[2])
    back_ref = stream_expand_plain(missed, ref[1], ref[0], [0.0, 7], ref[2])
    alive = missed == 0
    for a, b, x in zip(back, back_ref, planes):
        assert torch.equal(a, b)
        assert torch.equal(a[alive], x[alive])
    assert kb.LAUNCHES["stream_compact"] == kb.LAUNCHES["stream_expand"] == 1
    with pytest.raises(ValueError):
        stream_compact(missed, [planes[0].double()], [0.0])


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
