"""Scene tables: one flat structure-of-arrays of all objects (counterpart
of ``cpppathtracer_tpu/models/scene.py``).

Material fields follow `include/material.h:21-29`: kd f32[N,3] (albedo,
also scales emission), emission f32[N], smoothness f32[N] (Phong exponent
1000**smoothness), reflectivity f32[N], ior f32[N], tex_id i32[N].

Large scenes carry skip-pointer BVH tables over the grouped object order
(`with_bvh`, built on the host by ``ops/bvh.py``) and the walk kernel's
layout of them, which the per-bounce wavefront path walks with
``csrc/bvh.cu``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cpppathtracer_tpu_torch.ops.bvh import refit_skip_tables, skip_bvh_tables
from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import bvh_leaf_layout
from cpppathtracer_tpu_torch.types import MaterialType, PrimitiveType, resolve_device

# Scenes with at least this many objects get BVH tables when built, as in
# the JAX package (`models/scene.py:42`), and take the wavefront path.
AUTO_BVH_THRESHOLD = 2048


def type_partition(prim_type: np.ndarray) -> tuple[tuple, tuple]:
    """(type_perm, type_counts) of objects with these prim_types: the
    objects as [spheres | platforms | cylinders | padding], each group in
    the objects' own order, and (n_sphere, n_platform, n_cylinder)."""
    order = np.concatenate(
        [np.where(prim_type == t)[0] for t in (0, 1, 2)] + [np.where(prim_type < 0)[0]]
    )
    return (tuple(int(i) for i in order),
            tuple(int((prim_type == t).sum()) for t in (0, 1, 2)))


@dataclasses.dataclass
class Scene:
    """Flat SoA scene.  All tensors share leading dim N; padding objects
    have prim_type == -1 and never intersect.  `type_perm` orders objects
    as [spheres | platforms | cylinders | padding]; `type_counts` is
    (n_sphere, n_platform, n_cylinder)."""

    prim_type: torch.Tensor  # i32[N]
    center: torch.Tensor  # f32[N,3]
    radius: torch.Tensor  # f32[N]  (negative => inverted sphere normal)
    y_pos: torch.Tensor  # f32[N]  platform plane height
    height: torch.Tensor  # f32[N]  cylinder height
    mat_type: torch.Tensor  # i32[N]
    kd: torch.Tensor  # f32[N,3]
    emission: torch.Tensor  # f32[N]
    smoothness: torch.Tensor  # f32[N]
    reflectivity: torch.Tensor  # f32[N]
    ior: torch.Tensor  # f32[N]
    tex_id: torch.Tensor  # i32[N]
    type_perm: tuple = ()
    type_counts: tuple = ()
    # skip-pointer BVH over the grouped order (with_bvh), None when absent;
    # bvh_dims = (M nodes, K leaf size)
    bvh_meta: torch.Tensor | None = None  # i32[M,2] (escape, leaf_id)
    bvh_aabb: torch.Tensor | None = None  # f32[M,8] (min.xyz, max.xyz, pad)
    bvh_objs: torch.Tensor | None = None  # f32[L*K,8] leaf object rows
    bvh_dims: tuple = ()
    # the walk kernel's layout of the tables (bvh_leaf_layout), made with them
    bvh_layout: tuple | None = None

    @property
    def num_objects(self) -> int:
        return self.prim_type.shape[0]

    @property
    def device(self) -> torch.device:
        return self.center.device

    @functools.cached_property
    def type_perm_index(self) -> torch.Tensor:
        """`type_perm` as i64[N] on the scene's device, copied there once
        per scene: ``fast.group_scene`` reads it inside CUDA graphs, where
        no host-to-device copy may run."""
        return torch.tensor(self.type_perm, dtype=torch.int64, device=self.device)

    def _grouped_geometry(self):
        """The geometry fields in grouped order (type_perm), as numpy
        arrays."""
        perm = np.asarray(self.type_perm, np.int64)
        g = lambda a: a.detach().cpu().numpy()[perm]
        return g(self.center), g(self.radius), g(self.y_pos), g(self.height), g(self.prim_type)

    def with_bvh(self, leaf_size: int | None = None) -> "Scene":
        """Attach skip-pointer BVH tables, built on the host (rebuild or
        refit after geometry edits).  leaf_size None = the JAX package's
        rule, K = max(32, ceil8(ceil(N / 256))), which keeps M near 511
        nodes at any scene size.  A scene without type metadata (a
        hand-made Scene) raises ValueError, as in the JAX package: the
        tables index the grouped order."""
        if not self.type_perm or not self.type_counts:
            raise ValueError("with_bvh needs type-partition metadata")
        if leaf_size is None:
            k = -(-self.num_objects // 256)
            leaf_size = max(32, -(-k // 8) * 8)
        tables = skip_bvh_tables(*self._grouped_geometry(), leaf_size=leaf_size)
        dev = self.device
        return dataclasses.replace(
            self,
            bvh_meta=torch.from_numpy(tables["node_meta"]).to(dev),
            bvh_aabb=torch.from_numpy(tables["node_aabb"]).to(dev),
            bvh_objs=torch.from_numpy(tables["leaf_objs"]).to(dev),
            bvh_dims=(int(tables["node_meta"].shape[0]), int(tables["leaf_size"])),
        ).with_bvh_layout()

    def with_bvh_layout(self) -> "Scene":
        """Attach the walk kernel's layout of the attached tables, built
        from them (with_bvh and refit_bvh call it)."""
        return dataclasses.replace(self, bvh_layout=bvh_leaf_layout(
            self.bvh_meta, self.bvh_aabb, self.bvh_objs, self.bvh_dims[1]))

    def refit_bvh(self) -> "Scene":
        """Refit attached tables to moved geometry without a rebuild
        (`SceneBVH::UpdateObject`, `cuSrc/bvh.cu:122-157`): the topology
        is reused and winners equal a rebuild's."""
        if self.bvh_meta is None:
            return self
        aabb, objs = refit_skip_tables(
            self.bvh_meta.cpu().numpy(), self.bvh_aabb.cpu().numpy(),
            self.bvh_objs.cpu().numpy(), self.bvh_dims[1], *self._grouped_geometry(),
        )
        dev = self.device
        return dataclasses.replace(
            self, bvh_aabb=torch.from_numpy(aabb).to(dev), bvh_objs=torch.from_numpy(objs).to(dev)
        ).with_bvh_layout()

    def with_geometry(self, **fields) -> "Scene":
        """Edit geometry fields (center, radius, y_pos, height) and refit
        attached BVH tables to them.  A bare `dataclasses.replace` leaves
        the walk reading stale leaf rows (see `bvh_is_stale`)."""
        return dataclasses.replace(self, **fields).refit_bvh()

    def bvh_is_stale(self) -> bool:
        """True when attached leaf rows disagree with the geometry fields
        (a host-side check; ProgressiveRenderer runs it once)."""
        if self.bvh_meta is None:
            return False
        objs = self.bvh_objs.cpu().numpy()
        valid = objs[:, 6] >= 0
        oi = objs[:, 7].astype(np.int64)[valid]
        center, radius, y_pos, height, _ = self._grouped_geometry()
        return not (
            np.array_equal(objs[valid, 0:3], center[oi])
            and np.array_equal(objs[valid, 3], radius[oi])
            and np.array_equal(objs[valid, 4], y_pos[oi])
            and np.array_equal(objs[valid, 5], height[oi])
        )

    def material_params(self):
        """The material parameter sub-dict (albedo / roughness / IOR /
        emission)."""
        return {
            "kd": self.kd,
            "emission": self.emission,
            "smoothness": self.smoothness,
            "reflectivity": self.reflectivity,
            "ior": self.ior,
        }

    def with_material_params(self, params) -> "Scene":
        """The scene with these material fields.  The object order is
        unchanged, so the new scene shares this one's `type_perm_index`
        (made here once, outside any step): a training step calls this
        on every run, inside a CUDA graph too, where no host-to-device
        copy may run."""
        out = dataclasses.replace(self, **params)
        if self.type_perm:
            out.__dict__["type_perm_index"] = self.type_perm_index
        return out


@dataclasses.dataclass
class _ObjSpec:
    prim_type: int
    center: tuple
    radius: float
    y_pos: float
    height: float
    mat_type: int
    kd: tuple
    emission: float
    smoothness: float
    reflectivity: float
    ior: float
    tex_id: int


class SceneBuilder:
    """Host-side scene authoring (`PathTracer::AddObject`,
    `cuSrc/bvh.cu:22-29`), frozen into a `Scene` with `build()`."""

    def __init__(self):
        self._objs: list[_ObjSpec] = []

    def __len__(self):
        return len(self._objs)

    def _add(self, **kw) -> int:
        self._objs.append(_ObjSpec(**kw))
        return len(self._objs) - 1

    def _material(self, mat_type, kd, emission, smoothness, reflectivity, ior, tex_id):
        return dict(
            mat_type=int(mat_type),
            kd=tuple(map(float, kd)),
            emission=float(emission),
            smoothness=float(smoothness),
            reflectivity=float(reflectivity),
            ior=float(ior),
            tex_id=int(tex_id),
        )

    def add_sphere(self, center, radius, mat_type=MaterialType.DIFFUSE,
                   kd=(1.0, 1.0, 1.0), emission=0.0, smoothness=0.0,
                   reflectivity=0.0, ior=1.5, tex_id=-1) -> int:
        """Negative radius inverts the near-root normal: the reference's
        hollow-glass-shell trick (`cuSrc/object.cu:22-23`)."""
        return self._add(
            prim_type=int(PrimitiveType.SPHERE),
            center=tuple(map(float, center)), radius=float(radius),
            y_pos=0.0, height=0.0,
            **self._material(mat_type, kd, emission, smoothness, reflectivity, ior, tex_id),
        )

    def add_platform(self, y_pos, mat_type=MaterialType.DIFFUSE,
                     kd=(1.0, 1.0, 1.0), emission=0.0, smoothness=0.0,
                     reflectivity=0.0, ior=1.5, tex_id=-1) -> int:
        """Infinite plane perpendicular to y (`cuSrc/object.cu:37-48`)."""
        return self._add(
            prim_type=int(PrimitiveType.PLATFORM),
            center=(0.0, 0.0, 0.0), radius=0.0, y_pos=float(y_pos), height=0.0,
            **self._material(mat_type, kd, emission, smoothness, reflectivity, ior, tex_id),
        )

    def add_cylinder(self, center, radius, height, mat_type=MaterialType.DIFFUSE,
                     kd=(1.0, 1.0, 1.0), emission=0.0, smoothness=0.0,
                     reflectivity=0.0, ior=1.5, tex_id=-1) -> int:
        """Y-aligned capped cylinder (`cuSrc/object.cu:50-112`)."""
        return self._add(
            prim_type=int(PrimitiveType.CYLINDER),
            center=tuple(map(float, center)), radius=float(radius),
            y_pos=0.0, height=float(height),
            **self._material(mat_type, kd, emission, smoothness, reflectivity, ior, tex_id),
        )

    def build(self, device=None, pad_to: int | None = None, bvh: bool | None = None) -> Scene:
        """Freeze to a `Scene` on `device` (the CUDA card by default).
        `pad_to` rounds N up with inactive padding objects.  `bvh` attaches
        skip-pointer BVH tables (None: at AUTO_BVH_THRESHOLD objects or
        more).  The tables freeze the build's geometry: edit it through
        `Scene.with_geometry`, which refits them."""
        n = len(self._objs)
        m = n if pad_to is None else max(n, pad_to)
        if m == 0:
            raise ValueError("empty scene")
        if bvh is None:
            bvh = n >= AUTO_BVH_THRESHOLD
        dev = resolve_device(device)

        def arr(field, dtype=np.float32, dim=None):
            out = np.zeros((m,) if dim is None else (m, dim), dtype)
            for i, o in enumerate(self._objs):
                out[i] = getattr(o, field)
            return torch.from_numpy(out).to(dev)

        prim_type = np.full(m, -1, np.int32)
        for i, o in enumerate(self._objs):
            prim_type[i] = o.prim_type
        type_perm, type_counts = type_partition(prim_type)
        scene = Scene(
            type_perm=type_perm,
            type_counts=type_counts,
            prim_type=torch.from_numpy(prim_type).to(dev),
            center=arr("center", dim=3),
            radius=arr("radius"),
            y_pos=arr("y_pos"),
            height=arr("height"),
            mat_type=arr("mat_type", np.int32),
            kd=arr("kd", dim=3),
            emission=arr("emission"),
            smoothness=arr("smoothness"),
            reflectivity=arr("reflectivity"),
            ior=arr("ior"),
            tex_id=arr("tex_id", np.int32),
        )
        return scene.with_bvh() if bvh else scene


def demo_scene(seed: int = 0, pad_to: int | None = None) -> SceneBuilder:
    """The reference's procedural demo scene with deterministic RNG
    (`cppSrc/video_renderer.cpp:39-118`): 20 random materials, a floor
    platform at y=0, and spheres/cylinders marching z in [-550, 550) step
    15.  Glass objects get a nested negative-radius sphere shell half of
    the time; the reference's un-memset inner object is a sphere even for
    cylinders (`video_renderer.cpp:108-115`).  `pad_to` is accepted and
    ignored, as the JAX package's `demo_scene` ignores it."""
    rng = np.random.RandomState(seed)
    rnd = lambda: float(rng.uniform())

    mats = [dict(mat_type=MaterialType.DIFFUSE, kd=(0.95, 0.95, 0.95))]
    for _ in range(1, 20):
        kd = (rnd(), rnd(), rnd())
        kind = int(rnd() * 2048) % 4
        if kind == 1:
            mats.append(dict(mat_type=MaterialType.METAL, kd=kd,
                             smoothness=rnd() * 4 + 1.0, reflectivity=rnd() * 0.8))
        elif kind == 2:
            mats.append(dict(
                mat_type=MaterialType.MIRROR,
                kd=(0.5 + 0.5 * rnd(), 0.5 + 0.5 * rnd(), 0.5 + 0.5 * rnd()),
                smoothness=rnd() * 4 + 0.5,
            ))
        elif kind == 3:
            mats.append(dict(mat_type=MaterialType.GLASS, kd=(1.0, 1.0, 1.0),
                             smoothness=rnd() * 4 + 2.0, ior=rnd() * 2 + 1.2))
        else:
            mats.append(dict(mat_type=MaterialType.DIFFUSE, kd=kd))

    b = SceneBuilder()
    b.add_platform(0.0, **mats[0])
    for z in range(-550, 550, 15):
        m = mats[rng.randint(20)]
        if int(rnd() * 2048) % 2 == 0:
            radius = rnd() * 15.0 + 1.0
            center = (rnd() * 300.0 - 150.0, radius, float(z))
            b.add_sphere(center, radius, **m)
            if m["mat_type"] == MaterialType.GLASS and rnd() > 0.5:
                b.add_sphere(center, 0.01 - radius, **m)
        else:
            radius = rnd() * 15.0 + 1.0
            height = radius / 2 + rnd() * 20.0
            center = (rnd() * 300.0 - 150.0, height / 2, float(z))
            b.add_cylinder(center, radius, height, **m)
            if m["mat_type"] == MaterialType.GLASS and rnd() > 0.5:
                b.add_sphere(center, 0.01 - radius, **m)
    return b
