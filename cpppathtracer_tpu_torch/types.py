"""Constants, enums and the device rule of the PyTorch port.

Counterpart of ``cpppathtracer_tpu/types.py``: the tmin/tmax epsilons and
the primitive/material enums of the reference
(`include/ray_tracing_common.h:11-12`, `include/object.h:7-15`,
`include/material.h:5-15`).
"""

from __future__ import annotations

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
