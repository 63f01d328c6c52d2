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


BVH_FIELDS = {"bvh_meta": np.int32, "bvh_aabb": np.float32, "bvh_objs": np.float32}


def scene_from_numpy(fields: dict, type_perm, type_counts, device=None, bvh_dims=()) -> Scene:
    """A Scene from the JAX Scene's arrays (`fields`, keyed by field name)
    and its static partition metadata.  With `bvh_dims` (the JAX Scene's
    (M, K)), `fields` also holds its BVH tables bvh_meta, bvh_aabb and
    bvh_objs, which are carried across as they are, with the walk kernel's
    layout of them."""
    dev = resolve_device(device)
    names = dict(SCENE_FIELDS, **(BVH_FIELDS if bvh_dims else {}))
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"missing scene fields: {sorted(missing)}")
    scene = Scene(
        **{k: _tensor(fields[k], dt, dev) for k, dt in names.items()},
        type_perm=tuple(int(i) for i in type_perm),
        type_counts=tuple(int(c) for c in type_counts),
        bvh_dims=tuple(int(v) for v in bvh_dims),
    )
    return scene.with_bvh_layout() if bvh_dims else scene


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


def tex_stack_from_numpy(tex, device=None) -> torch.Tensor:
    """A stack of albedo textures f32[T,H,W,3] (an object's tex_id picks
    one)."""
    tex = np.asarray(tex, np.float32)
    if tex.ndim != 4 or tex.shape[-1] != 3:
        raise ValueError(f"tex_stack must be [T, H, W, 3], got {tex.shape}")
    return _tensor(tex, np.float32, resolve_device(device))
