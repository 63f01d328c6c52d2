"""PyTorch / CUDA port of cpppathtracer_tpu for NVIDIA Hopper.

The JAX package ``cpppathtracer_tpu`` is the reference; this package
imports nothing of it and no JAX.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``, which runs the plain PyTorch versions
of the kernels.  ``python -m cpppathtracer_tpu_torch`` is its command line.
"""

from cpppathtracer_tpu_torch.types import (
    BOUNCE_RAY_TMIN,
    DEFAULT_RAY_TMAX,
    MAX_RECURSION_DEPTH_SET,
    MaterialType,
    PrimitiveType,
    Rays,
)
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import Scene, SceneBuilder
from cpppathtracer_tpu_torch.integrator import render_radiance, render_sample
from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig

__version__ = "0.1.0"

__all__ = [
    "BOUNCE_RAY_TMIN",
    "DEFAULT_RAY_TMAX",
    "MAX_RECURSION_DEPTH_SET",
    "MaterialType",
    "PrimitiveType",
    "Rays",
    "Camera",
    "Scene",
    "SceneBuilder",
    "render_radiance",
    "render_sample",
    "ProgressiveRenderer",
    "RenderConfig",
]
