"""The type-grouped scene tables that every kernel reads, and the
per-bounce closest hit of the wavefront path (counterpart of
``cpppathtracer_tpu/ops/fast.py:48-126, 516-621``).

Objects are permuted into [spheres | platforms | cylinders | padding]
order, so the winner search runs only each group's own analytic test and
returns a *dense grouped* index.  The per-object record is two tables, as
in the JAX package, where the split keeps kd/emission cotangents separable
from the geometric chain:

table_s (13 columns): 0:2 center.xyz | 3 radius | 4 y_pos | 5 height |
  6 prim_type | 7 mat_type | 8 smoothness | 9 reflectivity | 10 ior |
  11 tex_id | 12 orig_idx
table_r (4 columns): 0:2 kd | 3 emission
"""

from __future__ import annotations

import dataclasses
import os

import torch

from cpppathtracer_tpu_torch.ops import planar
from cpppathtracer_tpu_torch.ops.cuda.bvh_kernel import bvh_winner_index
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import build_geom_rows, winner_index

F_S = 13
F_R = 4


@dataclasses.dataclass
class GroupedScene:
    center: torch.Tensor  # f32[Ng,3] grouped
    radius: torch.Tensor  # f32[Ng]
    y_pos: torch.Tensor  # f32[Ng]
    height: torch.Tensor  # f32[Ng]
    table_s: torch.Tensor  # f32[Ng,F_S]
    table_r: torch.Tensor  # f32[Ng,F_R]
    counts: tuple  # (n_sphere, n_platform, n_cylinder)
    # the scene's skip-pointer BVH tables (grouped indices), None when absent
    bvh_meta: torch.Tensor | None = None
    bvh_aabb: torch.Tensor | None = None
    bvh_objs: torch.Tensor | None = None
    bvh_dims: tuple = ()
    bvh_layout: tuple | None = None  # Scene.bvh_layout


def group_scene(scene) -> GroupedScene:
    """Repack a Scene in type-grouped order."""
    if not scene.type_perm or not scene.type_counts:
        raise ValueError("scene lacks its type-partition metadata")
    perm = torch.tensor(scene.type_perm, dtype=torch.int64, device=scene.device)
    g = lambda a: a.index_select(0, perm)
    center = g(scene.center)
    radius = g(scene.radius)
    y_pos = g(scene.y_pos)
    height = g(scene.height)
    col = lambda a: a.to(torch.float32)[:, None]
    table_s = torch.cat(
        [
            center, col(radius), col(y_pos), col(height),
            col(g(scene.prim_type)), col(g(scene.mat_type)),
            col(g(scene.smoothness)), col(g(scene.reflectivity)),
            col(g(scene.ior)), col(g(scene.tex_id)), col(perm),
        ],
        dim=1,
    )
    table_r = torch.cat([g(scene.kd), col(g(scene.emission))], dim=1)
    return GroupedScene(
        center=center, radius=radius, y_pos=y_pos, height=height,
        table_s=table_s, table_r=table_r, counts=tuple(scene.type_counts),
        bvh_meta=scene.bvh_meta, bvh_aabb=scene.bvh_aabb, bvh_objs=scene.bvh_objs,
        bvh_dims=tuple(scene.bvh_dims), bvh_layout=scene.bvh_layout,
    )


def use_bvh(gs) -> bool:
    """Whether the closest hit walks the BVH: the scene has tables and the
    environment does not set POCA_BVH=0 (the JAX package's switch)."""
    return gs.bvh_meta is not None and os.environ.get("POCA_BVH", "1") != "0"


def intersect_and_gather_planar(gs, o, d, tmin, tmax):
    """Closest hit and its record for planar rays (o, d tuples of f32[R]):
    the winner index by the BVH walk (``csrc/bvh.cu``) when
    :func:`use_bvh`, else by the dense search (``csrc/winner.cu``) over
    :func:`build_geom_rows` of `gs`, then the record fetch and hit
    attributes of ``planar.gather_epilogue_p``.

    The winner index is piecewise constant and carries no gradient; the
    epilogue is differentiable.  Returns (hitrec, mats)."""
    flat = lambda t: t.detach().contiguous()
    ray = ([flat(c) for c in o], [flat(c) for c in d], flat(tmin), flat(tmax))
    if use_bvh(gs):
        gidx = bvh_winner_index(*ray, gs.bvh_meta, gs.bvh_aabb, gs.bvh_objs,
                                leaf_size=gs.bvh_dims[1], layout=gs.bvh_layout)
    else:
        gidx = winner_index(gs.counts, *ray, build_geom_rows(gs).detach())
    return planar.gather_epilogue_p(gs.table_s, gs.table_r, o, d, tmin, tmax, gidx)
