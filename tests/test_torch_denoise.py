"""The denoiser's plain version (``ops/cuda/denoise_kernel.py``, the CPU
side of ``csrc/denoise.cu``) against the JAX package's ``ops/denoise.py``
and its scalar oracle, its wrapper's argument checks, the premise of the
kernel's pair factors, and the kernel's block of work
(``csrc/denoise.cuh``) built for the host by g++
(``tests/denoise_host.cpp``).  The kernel itself is held against the plain
version on the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import ctypes
import itertools
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpppathtracer_tpu.ops.denoise import denoise as j_denoise
from cpppathtracer_tpu.ops.denoise import denoise_np
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda import denoise_kernel

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent

# H or W under 5 (the 5x5 footprint), odd sizes, one pixel
SIZES = [(24, 32), (7, 13), (3, 17), (4, 4), (1, 1), (2, 9)]


def _inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    rad = rng.uniform(0, 2, (h, w, 3)).astype(np.float32)
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    dep = rng.uniform(0, 50, (h, w)).astype(np.float32)
    return rad, nrm, dep


@pytest.mark.parametrize("stepwidth", [1, 2])
@pytest.mark.parametrize("h,w", SIZES)
def test_denoise_plain_matches_jax(h, w, stepwidth):
    """The plain version against JAX's denoise at test_torch_render.py's
    rtol / atol of 1e-6, and against the JAX package's float64-accumulating
    oracle at the same bound."""
    rad, nrm, dep = _inputs(h, w, 7 * h + w)
    got = denoise_kernel.denoise_plain(*map(torch.from_numpy, (rad, nrm, dep)), stepwidth).numpy()
    ref = np.asarray(j_denoise(jnp.asarray(rad), jnp.asarray(nrm), jnp.asarray(dep), stepwidth))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, denoise_np(rad, nrm, dep, stepwidth), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stepwidth", [0, 1, 2, 3])
def test_denoise_on_cpu_is_the_plain_version(stepwidth):
    """The wrapper on CPU tensors: the plain version bit for bit, with no
    launch counted."""
    args = [torch.from_numpy(a) for a in _inputs(9, 11, stepwidth)]
    kb.reset_launches()
    ref = denoise_kernel.denoise_plain(*args, stepwidth)
    assert torch.equal(denoise_kernel.denoise(*args, stepwidth), ref)
    assert kb.LAUNCHES["denoise"] == 0


def test_denoise_on_cpu_differentiates():
    """On CPU tensors the wrapper is the plain version, autograd included:
    its radiance gradient is the plain version's."""
    rad, nrm, dep = (torch.from_numpy(a) for a in _inputs(7, 6, 1))
    cot = torch.from_numpy(np.random.RandomState(2).normal(size=(7, 6, 3)).astype(np.float32))
    grads = []
    for fn in (denoise_kernel.denoise, denoise_kernel.denoise_plain):
        leaf = rad.clone().requires_grad_()
        (fn(leaf, nrm, dep, 1) * cot).sum().backward()
        grads.append(leaf.grad)
    assert torch.isfinite(grads[0]).all() and grads[0].abs().sum() > 0
    assert torch.equal(grads[0], grads[1])


def _bad(case):
    rad, nrm, dep = (torch.from_numpy(a) for a in _inputs(6, 5, 0))
    if case == "dtype":
        rad = rad.double()
    elif case == "normal_shape":
        nrm = nrm[:, :4]
    elif case == "depth_shape":
        dep = dep[..., None]
    elif case == "radiance_rank":
        rad = rad[..., 0]
    elif case == "channels":
        rad, nrm = rad[..., :2], nrm[..., :2]
    elif case == "mixed_device":
        dep = dep.to("meta")
    elif case == "device_type":
        rad, nrm, dep = (t.to("meta") for t in (rad, nrm, dep))
    return rad, nrm, dep, {"stepwidth": -1, "stepwidth_float": 1.0}.get(case, 1)


@pytest.mark.parametrize("case", ["dtype", "normal_shape", "depth_shape", "radiance_rank",
                                  "channels", "mixed_device", "device_type", "stepwidth",
                                  "stepwidth_float"])
def test_denoise_rejects_bad_arguments(case):
    with pytest.raises(ValueError):
        denoise_kernel.denoise(*_bad(case))


def _pair_factor(centre, tap):
    """(c_w * n_w) * p_w of each pixel against its tap, as denoise_plain
    computes it: centre and tap are (radiance, normal, depth) of one shape."""
    sq = denoise_kernel._sq_sum3
    c_w = torch.exp(-sq(centre[0] - tap[0]) * denoise_kernel._INV_PI)
    n_w = torch.exp(-sq(centre[1] - tap[1]) * denoise_kernel._INV_PI)
    p_w = torch.exp(-((centre[2] - tap[2]) * (centre[2] - tap[2])) * denoise_kernel._INV_PI)
    return c_w * n_w * p_w


def _coarse_inputs(h, w, seed):
    """Inputs with repeated values and zeros: few distinct levels, and a
    quarter of the entries zero."""
    rng = np.random.RandomState(seed)
    out = []
    for shape, scale in (((h, w, 3), 2.0), ((h, w, 3), 1.0), ((h, w), 50.0)):
        a = (rng.randint(-3, 4, shape) * scale / 3).astype(np.float32)
        a[rng.uniform(size=shape) < 0.25] = 0.0
        out.append(torch.from_numpy(a))
    return out


@pytest.mark.parametrize("stepwidth", [1, 2])
@pytest.mark.parametrize("inputs", ["uniform", "coarse"])
def test_pair_factor_is_symmetric(inputs, stepwidth):
    """The premise of csrc/denoise.cuh's pair factors: the plain version's
    weight factor (c_w * n_w) * p_w of pixel p at offset o equals that of
    pixel p + o at offset -o bit for bit, for every offset of the 5x5
    footprint and every pair of pixels inside a 53x37 frame; and
    KERNEL_5X5 is symmetric under a half turn."""
    h, w = 37, 53
    args = ([torch.from_numpy(a) for a in _inputs(h, w, 11)] if inputs == "uniform"
            else _coarse_inputs(h, w, 12))
    k = torch.from_numpy(denoise_kernel.KERNEL_5X5)
    assert torch.equal(k, torch.flip(k, (0, 1)))
    pairs = 0
    for i, j in itertools.product(range(5), range(5)):
        dx, dy = (i - 2) * stepwidth, (j - 2) * stepwidth
        # p runs over the pixels whose p + o lies in the frame
        ys, xs = slice(max(0, -dy), h - max(0, dy)), slice(max(0, -dx), w - max(0, dx))
        ys2, xs2 = slice(ys.start + dy, ys.stop + dy), slice(xs.start + dx, xs.stop + dx)
        p = [a[ys, xs] for a in args]
        q = [a[ys2, xs2] for a in args]
        f_pq, f_qp = _pair_factor(p, q), _pair_factor(q, p)
        assert torch.equal(f_pq.view(torch.int32), f_qp.view(torch.int32)), (i, j)
        pairs += f_pq.numel()
    assert pairs > 25 * 0.7 * h * w


@pytest.fixture(scope="module")
def host_denoise(tmp_path_factory):
    """csrc/denoise.cuh's block of work built for the host by g++
    (tests/denoise_host.cpp): (tiled kernel, untiled kernel, loop), each
    called as f(rad, nrm, dep, stepwidth, *flags)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the denoise kernel's block of work for the host")
    lib = tmp_path_factory.mktemp("denoise_host") / "libdenoise_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(kb.CSRC), str(TESTS / "denoise_host.cpp"), "-o", str(lib)], check=True,
                   timeout=120)
    so = ctypes.CDLL(str(lib))
    so.poca_denoise_host.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    for fn in (so.poca_denoise_host_any, so.poca_denoise_loop):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    for fn in (so.poca_denoise_host, so.poca_denoise_host_any, so.poca_denoise_loop):
        fn.restype = ctypes.c_int

    def call(fn):
        def run(rad, nrm, dep, *extra):
            out = torch.empty_like(rad)
            h, w = rad.shape[:2]
            assert fn(rad.data_ptr(), nrm.data_ptr(), dep.data_ptr(), out.data_ptr(), h, w,
                      *extra) == 0
            return out
        return run

    return call(so.poca_denoise_host), call(so.poca_denoise_host_any), call(so.poca_denoise_loop)


def _same_bits(a, b):
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


# the 32 x 16 tile exactly, one pixel under and over a multiple of it in each direction,
# several tiles with interior blocks, H or W under 5
HOST_SIZES = [(16, 32), (15, 31), (17, 33), (31, 65), (33, 63), (56, 100), (3, 17), (1, 1)]


@pytest.mark.parametrize("stepwidth", [0, 1, 2, 3, 17])
@pytest.mark.parametrize("h,w", HOST_SIZES)
def test_denoise_host_build_matches_loop(host_denoise, h, w, stepwidth):
    """The kernels' work on the host: the tiled kernel's block (its tiles,
    halo, staged layout, pair factors and tap order) at each of its forms
    (the stepwidth fixed or read at run time, with or without pair factors,
    with or without the interior blocks' shortcut) and the untiled kernel
    of the other stepwidths, each bitwise equal
    to the plain version's arithmetic written as one loop a pixel (both
    with the host's expf), NaN where it is NaN: the seeded inputs carry an
    inf and a NaN radiance from 8x8 up.  The loop is within float32
    rounding of denoise_plain (the host's expf against torch's exp)."""
    kernel, untiled, loop = host_denoise
    args = [torch.from_numpy(a) for a in _inputs(h, w, 100 * h + w)]
    if h * w >= 64:
        args[0][h // 2, w // 3, 0] = float("inf")
        args[0][0, w - 1, 1] = float("nan")
    ref = loop(*args, stepwidth)
    for fixed, pairs, interior in itertools.product((1, 0), (1, 0), (1, 0)):
        got = kernel(*args, stepwidth, fixed, pairs, interior)
        assert _same_bits(got, ref), (fixed, pairs, interior)
    assert _same_bits(untiled(*args, stepwidth), ref)
    plain = denoise_kernel.denoise_plain(*args, stepwidth)
    assert torch.equal(torch.isnan(plain), torch.isnan(ref))
    fin = ~torch.isnan(plain)
    np.testing.assert_allclose(ref[fin].numpy(), plain[fin].numpy(), rtol=2e-6, atol=2e-6)
