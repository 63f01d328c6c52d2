"""Named benchmark configurations (counterpart of
``cpppathtracer_tpu/models/presets.py``): the same scenes, cameras and
render settings, and the port's own `rtow_final`, which also brings its
sky.  Every constructor takes `device` (the CUDA card by default, as every
entry point of the port)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import SceneBuilder, demo_scene
from cpppathtracer_tpu_torch.types import MaterialType, resolve_device


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    width: int
    height: int
    spp: int
    max_depth: int
    scene_fn: object
    camera_fn: object
    # the preset's own sky, f32[H, W, 3] on `device`; None: the command's default sky
    sky_fn: object = None

    def build(self, device=None):
        return self.scene_fn(device=device), self.camera_fn(device=device)


def _cornell_scene(device=None):
    """One diffuse sphere on a platform under the sky."""
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.95, 0.95, 0.95))
    b.add_sphere((0.0, 3.0, 0.0), 3.0, kd=(0.7, 0.3, 0.3))
    return b.build(device=device)


def _cornell_camera(w=256, h=256, device=None):
    return Camera.make(w, h, origin=(0.0, 6.0, -18.0), look_at=(0.0, 3.0, 0.0),
                       view_fov=40.0, device=device)


def _zoo_scene(device=None):
    """Diffuse, metal, mirror and glass spheres (all four BSDFs)."""
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    b.add_sphere((-7.5, 2.5, 0.0), 2.5, mat_type=MaterialType.DIFFUSE, kd=(0.8, 0.3, 0.2))
    b.add_sphere((-2.5, 2.5, 0.0), 2.5, mat_type=MaterialType.METAL, kd=(0.9, 0.8, 0.4),
                 smoothness=3.0)
    b.add_sphere((2.5, 2.5, 0.0), 2.5, mat_type=MaterialType.MIRROR, kd=(0.8, 0.8, 0.9),
                 smoothness=2.0, reflectivity=0.7)
    b.add_sphere((7.5, 2.5, 0.0), 2.5, mat_type=MaterialType.GLASS, kd=(1.0, 1.0, 1.0),
                 smoothness=4.0, ior=1.5)
    b.add_sphere((7.5, 2.5, 0.0), 0.01 - 2.5, mat_type=MaterialType.GLASS,
                 kd=(1.0, 1.0, 1.0), smoothness=4.0, ior=1.5)
    return b.build(device=device)


def _zoo_camera(w=512, h=512, device=None):
    return Camera.make(w, h, origin=(0.0, 6.0, -20.0), look_at=(0.0, 2.5, 0.0),
                       view_fov=45.0, device=device)


def _hundred_scene(device=None):
    """About 100 spheres and cylinders on a platform."""
    rng = np.random.RandomState(42)
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    mats = []
    for _ in range(16):
        t = rng.randint(4)
        mats.append(
            dict(
                mat_type=MaterialType(t),
                kd=tuple(rng.uniform(0.2, 1.0, 3)) if t != MaterialType.GLASS else (1.0, 1.0, 1.0),
                smoothness=float(rng.uniform(0.5, 4.0)),
                reflectivity=float(rng.uniform(0.0, 0.8)),
                ior=float(rng.uniform(1.2, 2.2)),
            )
        )
    for i in range(100):
        m = mats[rng.randint(16)]
        x = float(rng.uniform(-120, 120))
        z = float(rng.uniform(-120, 120))
        if i % 2 == 0:
            r = float(rng.uniform(1.5, 8.0))
            b.add_sphere((x, r, z), r, **m)
        else:
            r = float(rng.uniform(1.5, 6.0))
            h = float(rng.uniform(3.0, 16.0))
            b.add_cylinder((x, h / 2, z), r, h, **m)
    return b.build(device=device)


def _bench_camera(w=1024, h=1024, device=None):
    return Camera.make(w, h, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0),
                       device=device)


def big_scene(n: int = 1024, seed: int = 7, bvh: bool | None = None, device=None):
    """The N-object stress scene of the BVH walk: a jittered grid of
    spheres and cylinders (2:1) over a floor, 5% of them emissive.  At
    AUTO_BVH_THRESHOLD objects or more it gets BVH tables."""
    rng = np.random.RandomState(seed)
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    side = int(np.ceil(np.sqrt(n)))
    pitch = 14.0
    ext = side * pitch / 2
    count = 0
    for gx in range(side):
        for gz in range(side):
            if count >= n - 1:
                break
            x = gx * pitch - ext + float(rng.uniform(-4, 4))
            z = gz * pitch - ext + float(rng.uniform(-4, 4))
            t = int(rng.randint(4))
            m = dict(
                mat_type=MaterialType(t),
                kd=(1.0, 1.0, 1.0) if t == MaterialType.GLASS
                else tuple(rng.uniform(0.2, 1.0, 3)),
                smoothness=float(rng.uniform(0.5, 4.0)),
                reflectivity=float(rng.uniform(0.0, 0.8)),
                ior=float(rng.uniform(1.2, 2.2)),
                emission=float(rng.uniform(0.0, 2.0)) if rng.uniform() < 0.05 else 0.0,
            )
            if count % 3 == 2:
                r = float(rng.uniform(1.0, 4.0))
                h = float(rng.uniform(3.0, 10.0))
                b.add_cylinder((x, h / 2, z), r, h, **m)
            else:
                r = float(rng.uniform(1.0, 5.0))
                b.add_sphere((x, r, z), r, **m)
            count += 1
    return b.build(device=device, bvh=bvh)


def big_camera(n: int = 1024, w=1024, h=1024, device=None):
    """A camera above a corner of big_scene(n), looking at its centre."""
    side = int(np.ceil(np.sqrt(n)))
    ext = side * 14.0 / 2
    return Camera.make(w, h, origin=(ext * 1.2, ext * 0.8, ext * 1.2),
                       look_at=(0.0, 0.0, 0.0), view_fov=50.0, device=device)


# ---- the final render of "Ray Tracing in One Weekend" (P. Shirley, T. D. Black,
# S. Hollasch; raytracing.github.io, book 1, v3.2.3, section 13.1 "A Final
# Render": random_scene() and main()), mapped onto the port's four BSDFs

RTOW_ORIGIN = (13.0, 2.0, 3.0)
# 10 units (the book's focus distance) from the origin toward (0, 0, 0): the
# lens focuses at |origin - look_at|
RTOW_LOOK_AT = (3.36376, 0.51750, 0.77625)
RTOW_SKY_TOP = (0.5, 0.7, 1.0)


def rtow_metal_smoothness(fuzz: float) -> float:
    """The smoothness whose Phong lobe (exponent 1000**smoothness) is about
    as wide as the book's fuzz sphere: exponent 2 / fuzz^2, at most 1."""
    return 1.0 if fuzz <= 0.0 else min(1.0, math.log(2.0 / (fuzz * fuzz)) / math.log(1000.0))


def rtow_final_scene(seed: int = 0, half: int = 11, device=None):
    """The book's `random_scene`: a diffuse ground sphere of radius 1000, a
    small sphere of radius 0.2 at (a + 0.9 r, 0.2, b + 0.9 r) for a, b in
    -half ... half - 1 (skipped within 0.9 of (4, 0.2, 0)), diffuse 80%,
    metal 15%, glass 5%, then three spheres of radius 1.  The book's
    random_double() is unseeded: here it is `np.random.default_rng(seed)`,
    drawn in the book's order.  Diffuse is DIFFUSE with kd the albedo;
    metal METAL with kd the albedo and :func:`rtow_metal_smoothness`;
    glass GLASS, kd 1, ior 1.5, smoothness 1."""
    rng = np.random.default_rng(seed)
    rnd = lambda: float(rng.random())
    glass = dict(mat_type=MaterialType.GLASS, kd=(1.0, 1.0, 1.0), smoothness=1.0, ior=1.5)

    def metal(albedo, fuzz):
        return dict(mat_type=MaterialType.METAL, kd=albedo,
                    smoothness=rtow_metal_smoothness(fuzz))

    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, kd=(0.5, 0.5, 0.5))
    for a in range(-half, half):
        for bz in range(-half, half):
            choose = rnd()
            center = (a + 0.9 * rnd(), 0.2, bz + 0.9 * rnd())
            if math.dist(center, (4.0, 0.2, 0.0)) <= 0.9:
                continue
            if choose < 0.8:
                c1 = (rnd(), rnd(), rnd())
                c2 = (rnd(), rnd(), rnd())
                m = dict(kd=tuple(x * y for x, y in zip(c1, c2)))
            elif choose < 0.95:
                albedo = (0.5 + 0.5 * rnd(), 0.5 + 0.5 * rnd(), 0.5 + 0.5 * rnd())
                m = metal(albedo, 0.5 * rnd())
            else:
                m = glass
            b.add_sphere(center, 0.2, **m)
    b.add_sphere((0.0, 1.0, 0.0), 1.0, **glass)
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, kd=(0.4, 0.2, 0.1))
    b.add_sphere((4.0, 1.0, 0.0), 1.0, **metal((0.7, 0.6, 0.5), 0.0))
    return b.build(device=device)


def rtow_final_camera(w=1200, h=800, device=None):
    """The book's camera: from (13, 2, 3) toward the origin, vertical fov
    20 degrees, aperture 0.1 (lens radius 0.05), focus distance 10."""
    return Camera.make(w, h, origin=RTOW_ORIGIN, look_at=RTOW_LOOK_AT, view_fov=20.0,
                       lens_radius=0.05, device=device)


def rtow_sky(height: int = 256, width: int = 512) -> np.ndarray:
    """The book's sky, white blended to (0.5, 0.7, 1) by 0.5 (1 + dir.y), as
    a map f32[H, W, 3] for the sky lookup (``ops/texture.py::sky_uv``): at
    each texel centre (u, v) the direction's |y| is cos(pi (v - 1/2))
    |sin(2 pi u)|.  The lookup reads (x, y, z) and (-x, -y, z) at one
    texel, so a downward direction sees its mirror image above the
    horizon."""
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    u = (np.arange(width, dtype=np.float64) + 0.5) / width
    t = 0.5 * (1.0 + np.cos(np.pi * (v - 0.5))[:, None] * np.abs(np.sin(2.0 * np.pi * u))[None, :])
    top = np.asarray(RTOW_SKY_TOP, np.float64)
    return ((1.0 - t)[..., None] + t[..., None] * top).astype(np.float32)


def _rtow_sky_tex(device=None):
    return torch.from_numpy(rtow_sky()).to(resolve_device(device))


def _demo(device=None):
    return demo_scene(seed=0).build(device=device)


PRESETS = {
    "cornell": Preset("cornell", 256, 256, 4, 4, _cornell_scene, _cornell_camera),
    "material_zoo": Preset("material_zoo", 512, 512, 16, 8, _zoo_scene, _zoo_camera),
    "hundred_objects": Preset(
        "hundred_objects", 1024, 1024, 64, 8, _hundred_scene, _bench_camera
    ),
    "demo": Preset("demo", 1280, 720, 1, 8, _demo,
                   lambda device=None: _bench_camera(1280, 720, device=device)),
    "thousand_objects": Preset(
        "thousand_objects", 1024, 1024, 16, 8, big_scene, big_camera
    ),
    "rtow_final": Preset("rtow_final", 1200, 800, 500, 50, rtow_final_scene, rtow_final_camera,
                         sky_fn=_rtow_sky_tex),
}
