"""Scenes and rays shared by the port's CPU and GPU tests; imports no JAX,
so tests/test_torch_cuda.py can use them where only PyTorch is installed."""

import numpy as np
import torch

from cpppathtracer_tpu_torch.models.scene import SceneBuilder
from cpppathtracer_tpu_torch.types import INF


def tie_scene(device="cpu"):
    """Exact ties within and across leaves (leaf size 2): a column of 12
    cylinders of one axis and radius whose heights overlap, so a ray that
    meets the column's side meets several of them at the same t, added
    top first, so the walk, which splits this scene along y and visits
    the lower leaves first, reaches the later-added copies first; and
    above it three stacks of three exact sphere copies."""
    b = SceneBuilder()
    for i in range(12):
        b.add_cylinder((0.0, 30.0 - 2.0 * i, 0.0), 3.0, 12.0)
    for y in (44.0, 50.0, 56.0):
        for _ in range(3):
            b.add_sphere((0.0, y, 0.0), 2.5)
    return b.build(device=device, bvh=False).with_bvh(2)


def tie_rays(r, device="cpu"):
    """`r` rays of tie_scene from a ring around the column, aimed at
    points on it, with tmin 0 and tmax INF."""
    rng = np.random.RandomState(8)
    ang = rng.uniform(0, 2 * np.pi, r)
    o = np.stack([40 * np.cos(ang), rng.uniform(-5, 65, r), 40 * np.sin(ang)], 1)
    target = np.stack([rng.uniform(-2, 2, r), rng.uniform(0, 60, r), rng.uniform(-2, 2, r)], 1)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = lambda a, i: torch.from_numpy(a[:, i].astype(np.float32)).to(device)
    return (tuple(f(o, i) for i in range(3)), tuple(f(d, i) for i in range(3)),
            torch.zeros(r, device=device), torch.full((r,), INF, device=device))
