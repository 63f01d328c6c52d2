"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the same objects, made once with the JAX package and carried
across as numpy arrays through ``cpppathtracer_tpu_torch.convert``."""

import numpy as np

from cpppathtracer_tpu.models.scene import SceneBuilder
from cpppathtracer_tpu.types import MaterialType
from cpppathtracer_tpu_torch import convert

from torch_run_body import Replay, RunBody  # noqa: F401  (the tests import them from here)


def port_scene(scene):
    """The JAX scene in the port, with its BVH tables when it has them."""
    names = list(convert.SCENE_FIELDS)
    if scene.bvh_meta is not None:
        names += list(convert.BVH_FIELDS)
    fields = {k: np.asarray(getattr(scene, k)) for k in names}
    return convert.scene_from_numpy(fields, scene.type_perm, scene.type_counts, device="cpu",
                                    bvh_dims=scene.bvh_dims)


def port_camera(cam):
    fields = {k: np.asarray(getattr(cam, k)) for k in convert.CAMERA_FIELDS}
    return convert.camera_from_numpy(fields, cam.width, cam.height, device="cpu")


def port_sky(sky):
    return convert.sky_from_numpy(np.asarray(sky), device="cpu")


def controlled_scene(pad_to=None):
    """The controlled scene of tests/test_mega.py: no grazing tangencies;
    `pad_to` appends padding objects (prim_type -1)."""
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.3, 0.2))
    b.add_sphere((4.5, 1.5, 1.0), 1.5, mat_type=MaterialType.METAL, smoothness=0.8)
    b.add_cylinder((-4.5, 1.5, 0.0), 1.2, 3.0, mat_type=MaterialType.GLASS, ior=1.5)
    b.add_sphere((2.0, 1.0, -3.0), 1.0, kd=(1.0, 0.9, 0.7), emission=2.0)
    return b.build(pad_to=pad_to)
