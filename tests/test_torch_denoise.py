"""The denoiser's plain version (``ops/cuda/denoise_kernel.py``, the CPU
side of ``csrc/denoise.cu``) against the JAX package's ``ops/denoise.py``
and its scalar oracle, and its wrapper's argument checks.  The kernel
itself is held against the plain version on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpppathtracer_tpu.ops.denoise import denoise as j_denoise
from cpppathtracer_tpu.ops.denoise import denoise_np
from cpppathtracer_tpu_torch.ops.cuda import build as kb
from cpppathtracer_tpu_torch.ops.cuda import denoise_kernel

torch.set_num_threads(1)

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
    return rad, nrm, dep, -1 if case == "stepwidth" else 1


@pytest.mark.parametrize("case", ["dtype", "normal_shape", "depth_shape", "radiance_rank",
                                  "channels", "mixed_device", "device_type", "stepwidth"])
def test_denoise_rejects_bad_arguments(case):
    with pytest.raises(ValueError):
        denoise_kernel.denoise(*_bad(case))
