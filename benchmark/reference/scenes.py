"""The benchmark's own inputs: frozen copies of the scene generators and the
procedural sky, as NumPy arrays.

These are copies, kept here so that no later change to the program can move
the yardstick: `demo_scene(0)` (the reference's procedural demo scene,
`cppSrc/video_renderer.cpp:39-118`), `big_scene(n, seed=7)` (the
`thousand_objects` preset's jittered grid) with its corner camera, and
`procedural_sky(256, 256)`.  Both the program and the plain reference are
built from these arrays.

A scene is a dict of arrays over N objects, in the order the generator adds
them: prim_type i32 (0 sphere, 1 platform, 2 cylinder), center f32[N, 3],
radius, y_pos, height f32, mat_type i32 (0 diffuse, 1 metal, 2 mirror,
3 glass), kd f32[N, 3], emission, smoothness, reflectivity, ior f32, tex_id
i32 (-1: no texture).
"""

from __future__ import annotations

import numpy as np

FIELDS = {
    "prim_type": np.int32, "center": np.float32, "radius": np.float32,
    "y_pos": np.float32, "height": np.float32, "mat_type": np.int32,
    "kd": np.float32, "emission": np.float32, "smoothness": np.float32,
    "reflectivity": np.float32, "ior": np.float32, "tex_id": np.int32,
}

DIFFUSE, METAL, MIRROR, GLASS = 0, 1, 2, 3
SPHERE, PLATFORM, CYLINDER = 0, 1, 2


class _Objects:
    """Objects added one at a time, frozen into arrays by `arrays()`."""

    def __init__(self):
        self.rows = []

    def _add(self, prim, center, radius, y_pos, height, mat_type=DIFFUSE, kd=(1.0, 1.0, 1.0),
             emission=0.0, smoothness=0.0, reflectivity=0.0, ior=1.5):
        self.rows.append(dict(prim_type=prim, center=tuple(map(float, center)),
                              radius=float(radius), y_pos=float(y_pos), height=float(height),
                              mat_type=int(mat_type), kd=tuple(map(float, kd)),
                              emission=float(emission), smoothness=float(smoothness),
                              reflectivity=float(reflectivity), ior=float(ior), tex_id=-1))

    def sphere(self, center, radius, **m):
        self._add(SPHERE, center, radius, 0.0, 0.0, **m)

    def platform(self, y_pos, **m):
        self._add(PLATFORM, (0.0, 0.0, 0.0), 0.0, y_pos, 0.0, **m)

    def cylinder(self, center, radius, height, **m):
        self._add(CYLINDER, center, radius, 0.0, height, **m)

    def arrays(self) -> dict:
        return {k: np.array([r[k] for r in self.rows], dtype=dt) for k, dt in FIELDS.items()}


def demo_scene(seed: int = 0) -> dict:
    """93 objects at seed 0: a floor platform and spheres / cylinders (with
    nested negative-radius glass shells) marching z in [-550, 550)."""
    rng = np.random.RandomState(seed)
    rnd = lambda: float(rng.uniform())
    mats = [dict(mat_type=DIFFUSE, kd=(0.95, 0.95, 0.95))]
    for _ in range(1, 20):
        kd = (rnd(), rnd(), rnd())
        kind = int(rnd() * 2048) % 4
        if kind == 1:
            mats.append(dict(mat_type=METAL, kd=kd, smoothness=rnd() * 4 + 1.0,
                             reflectivity=rnd() * 0.8))
        elif kind == 2:
            mats.append(dict(mat_type=MIRROR,
                             kd=(0.5 + 0.5 * rnd(), 0.5 + 0.5 * rnd(), 0.5 + 0.5 * rnd()),
                             smoothness=rnd() * 4 + 0.5))
        elif kind == 3:
            mats.append(dict(mat_type=GLASS, kd=(1.0, 1.0, 1.0), smoothness=rnd() * 4 + 2.0,
                             ior=rnd() * 2 + 1.2))
        else:
            mats.append(dict(mat_type=DIFFUSE, kd=kd))
    b = _Objects()
    b.platform(0.0, **mats[0])
    for z in range(-550, 550, 15):
        m = mats[rng.randint(20)]
        if int(rnd() * 2048) % 2 == 0:
            radius = rnd() * 15.0 + 1.0
            center = (rnd() * 300.0 - 150.0, radius, float(z))
            b.sphere(center, radius, **m)
            if m["mat_type"] == GLASS and rnd() > 0.5:
                b.sphere(center, 0.01 - radius, **m)
        else:
            radius = rnd() * 15.0 + 1.0
            height = radius / 2 + rnd() * 20.0
            center = (rnd() * 300.0 - 150.0, height / 2, float(z))
            b.cylinder(center, radius, height, **m)
            if m["mat_type"] == GLASS and rnd() > 0.5:
                b.sphere(center, 0.01 - radius, **m)
    return b.arrays()


def big_scene(n: int = 1024, seed: int = 7) -> dict:
    """The N-object jittered grid of spheres and cylinders (2:1) over a
    floor, 5% of them emissive."""
    rng = np.random.RandomState(seed)
    b = _Objects()
    b.platform(0.0, kd=(0.9, 0.9, 0.9))
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
                mat_type=t,
                kd=(1.0, 1.0, 1.0) if t == GLASS else tuple(rng.uniform(0.2, 1.0, 3)),
                smoothness=float(rng.uniform(0.5, 4.0)),
                reflectivity=float(rng.uniform(0.0, 0.8)),
                ior=float(rng.uniform(1.2, 2.2)),
                emission=float(rng.uniform(0.0, 2.0)) if rng.uniform() < 0.05 else 0.0,
            )
            if count % 3 == 2:
                r = float(rng.uniform(1.0, 4.0))
                h = float(rng.uniform(3.0, 10.0))
                b.cylinder((x, h / 2, z), r, h, **m)
            else:
                r = float(rng.uniform(1.0, 5.0))
                b.sphere((x, r, z), r, **m)
            count += 1
    return b.arrays()


def big_camera(n: int) -> dict:
    """The camera above a corner of big_scene(n), looking at its centre."""
    side = int(np.ceil(np.sqrt(n)))
    ext = side * 14.0 / 2
    return dict(origin=(ext * 1.2, ext * 0.8, ext * 1.2), look_at=(0.0, 0.0, 0.0),
                view_fov=50.0)


def procedural_sky(height: int = 256, width: int = 256, seed: int = 0) -> np.ndarray:
    """The built-in sky f32[H, W, 3]: gradient, sun disc, soft clouds."""
    rng = np.random.RandomState(seed)
    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    horizon = np.array([0.9, 0.85, 0.75], np.float32)
    zenith = np.array([0.25, 0.45, 0.85], np.float32)
    t = np.abs(y - 0.5) * 2.0
    base = horizon * (1 - t[..., None]) + zenith * t[..., None]
    sun_u, sun_v = 0.1, 0.75
    d2 = (x - sun_u) ** 2 + (y - sun_v) ** 2
    sun = np.exp(-d2 / 0.002)[..., None] * np.array([3.0, 2.7, 2.2], np.float32)
    clouds = np.zeros((height, width), np.float32)
    for k in range(1, 5):
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        clouds += np.sin(2 * np.pi * k * x + ph1) * np.sin(2 * np.pi * k * y + ph2) / k
    clouds = np.clip(clouds, 0, None)[..., None] * 0.15
    return np.clip(base + sun + clouds, 0.0, 1.0).astype(np.float32)


def type_partition(prim_type: np.ndarray):
    """(type_perm, type_counts): the objects grouped as [spheres | platforms
    | cylinders], each group in the objects' own order, and the group
    sizes."""
    order = np.concatenate([np.where(prim_type == t)[0] for t in (0, 1, 2)])
    return [int(i) for i in order], [int((prim_type == t).sum()) for t in (0, 1, 2)]


SCENES = {"demo_scene": demo_scene, "big_scene": big_scene}


def make_scene(spec: dict) -> dict:
    """A configuration's `scene` entry ({"generator": name, "args": {...}})
    as arrays."""
    return SCENES[spec["generator"]](**spec.get("args", {}))


def make_camera(spec: dict) -> dict:
    """A configuration's `camera` entry: explicit origin / look_at / view_fov,
    or {"generator": "big_camera", "n": N}."""
    if spec.get("generator") == "big_camera":
        return big_camera(spec["n"])
    return dict(origin=tuple(spec["origin"]), look_at=tuple(spec["look_at"]),
                view_fov=float(spec.get("view_fov", 30.0)))
