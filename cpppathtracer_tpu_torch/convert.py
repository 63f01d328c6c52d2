"""Carry state from the JAX package's objects, given as numpy arrays, into
the port's.  The tests use it to feed both packages the identical scene,
camera and sky; the port itself imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import Scene
from cpppathtracer_tpu_torch.types import resolve_device

SCENE_FIELDS = {
    "prim_type": np.int32, "center": np.float32, "radius": np.float32,
    "y_pos": np.float32, "height": np.float32, "mat_type": np.int32,
    "kd": np.float32, "emission": np.float32, "smoothness": np.float32,
    "reflectivity": np.float32, "ior": np.float32, "tex_id": np.int32,
}

CAMERA_FIELDS = ("origin", "look_at", "view_fov", "lens_radius", "move_speed")


def _tensor(a, dtype, device):
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def scene_from_numpy(fields: dict, type_perm, type_counts, device=None) -> Scene:
    """A Scene from the JAX Scene's arrays (`fields`, keyed by field name)
    and its static partition metadata."""
    dev = resolve_device(device)
    missing = set(SCENE_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing scene fields: {sorted(missing)}")
    return Scene(
        **{k: _tensor(fields[k], dt, dev) for k, dt in SCENE_FIELDS.items()},
        type_perm=tuple(int(i) for i in type_perm),
        type_counts=tuple(int(c) for c in type_counts),
    )


def camera_from_numpy(fields: dict, width: int, height: int, device=None) -> Camera:
    """A Camera from the JAX Camera's arrays (`fields`, keyed by field
    name) and its static size."""
    dev = resolve_device(device)
    return Camera(
        **{k: _tensor(fields[k], np.float32, dev) for k in CAMERA_FIELDS},
        width=int(width), height=int(height),
    )


def sky_from_numpy(sky, device=None) -> torch.Tensor:
    """A sky texture f32[H,W,3]."""
    sky = np.asarray(sky, np.float32)
    if sky.ndim != 3 or sky.shape[-1] != 3:
        raise ValueError(f"sky must be [H, W, 3], got {sky.shape}")
    return _tensor(sky, np.float32, resolve_device(device))
