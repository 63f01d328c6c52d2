"""Constants, enums and the device rule of the PyTorch port.

Counterpart of ``cpppathtracer_tpu/types.py``: the tmin/tmax epsilons and
the primitive/material enums of the reference
(`include/ray_tracing_common.h:11-12`, `include/object.h:7-15`,
`include/material.h:5-15`), the row-major ray batch `Rays` and its hit
record `Hit` (`ray_tracing_common.h:26-35`).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

DEFAULT_RAY_TMAX = 1e30
BOUNCE_RAY_TMIN = 2e-5
MAX_RECURSION_DEPTH_SET = 32

# float32 values of the two epsilons, as python floats (bit-exact)
INF = float(np.float32(DEFAULT_RAY_TMAX))
TMIN_BOUNCE = float(np.float32(BOUNCE_RAY_TMIN))


class PrimitiveType(enum.IntEnum):
    SPHERE = 0
    PLATFORM = 1  # infinite plane perpendicular to y
    CYLINDER = 2  # y-axis-aligned capped cylinder


class MaterialType(enum.IntEnum):
    """Behaviour per enum value (the reference crosswires names and
    shaders, `cuSrc/material.cu:147-163`): METAL runs the Phong lobe around
    the mirror direction, MIRROR reflects with probability `reflectivity`
    and is diffuse otherwise, GLASS refracts with Schlick Fresnel.  Any
    other value (TEST included) shades as DIFFUSE."""

    DIFFUSE = 0
    METAL = 1
    MIRROR = 2
    GLASS = 3
    TEST = 4


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA card.  Without a card and without an explicit device this raises;
    the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


@dataclasses.dataclass
class Rays:
    """A batch of rays, row-major: origin and dir f32[..., 3] (dir
    normalized by convention), tmin and tmax f32[...]."""

    origin: torch.Tensor
    dir: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor

    @staticmethod
    def make(origin, dir, tmin=None, tmax=None, device=None) -> "Rays":
        """Rays from array-likes; tmin defaults to 0 and tmax to
        DEFAULT_RAY_TMAX.  A tensor keeps its device; anything else goes to
        `device` (the CUDA card by default)."""
        dev = origin.device if isinstance(origin, torch.Tensor) else resolve_device(device)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        origin, dir = f32(origin), f32(dir)
        batch = origin.shape[:-1]
        tmin = torch.zeros(batch, dtype=torch.float32, device=dev) if tmin is None else f32(tmin)
        tmax = torch.full(batch, INF, dtype=torch.float32, device=dev) if tmax is None else f32(tmax)
        return Rays(origin, dir, tmin, tmax)

    @property
    def batch_shape(self):
        return self.origin.shape[:-1]


@dataclasses.dataclass
class Hit:
    """Closest hit of a ray batch: t f32[...] (DEFAULT_RAY_TMAX on a miss),
    hit bool[...], pos and normal f32[..., 3], obj_idx i32[...] (the
    scene's object index, -1 on a miss)."""

    t: torch.Tensor
    hit: torch.Tensor
    pos: torch.Tensor
    normal: torch.Tensor
    obj_idx: torch.Tensor
