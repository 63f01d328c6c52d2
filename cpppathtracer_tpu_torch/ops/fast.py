"""The type-grouped scene tables that every kernel reads, and the
per-bounce closest hit of the planar wavefront path and of the row-major
body (counterpart of ``cpppathtracer_tpu/ops/fast.py``).

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
from cpppathtracer_tpu_torch.ops.cuda.intersect_kernel import (
    build_geom_rows,
    winner_index,
    winner_t_index_plain,
)
from cpppathtracer_tpu_torch.ops.intersect import _object_hit_attrs
from cpppathtracer_tpu_torch.types import INF, Hit

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


def group_scene(scene) -> GroupedScene | None:
    """Repack a Scene in its type-grouped order (`type_perm`,
    `type_counts`).  A scene without that metadata (a hand-made Scene)
    gives None, and its renders take the row-major body with the dense
    ``intersect.intersect``, as in the JAX package (`fast.py:83-88`)."""
    if not scene.type_perm or not scene.type_counts:
        return None
    counts = tuple(scene.type_counts)
    perm = scene.type_perm_index
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
        table_s=table_s, table_r=table_r, counts=counts,
        bvh_meta=scene.bvh_meta, bvh_aabb=scene.bvh_aabb, bvh_objs=scene.bvh_objs,
        bvh_dims=tuple(scene.bvh_dims), bvh_layout=scene.bvh_layout,
    )


def use_bvh(gs) -> bool:
    """Whether the closest hit walks the BVH: the scene has tables and the
    environment does not set POCA_BVH=0 (the JAX package's switch)."""
    return gs.bvh_meta is not None and os.environ.get("POCA_BVH", "1") != "0"


def _ray_planes(o, d, tmin, tmax):
    """The 8 contiguous f32[R] planes that the winner searches read, cut
    from the graph.  Planes that are strided views (the columns of
    row-major rays) are copied, once per call."""
    flat = lambda t: t.detach().contiguous()
    return [flat(c) for c in o], [flat(c) for c in d], flat(tmin), flat(tmax)


def dense_index(gs, o, d, tmin, tmax):
    """Dense grouped winner index i32[R] of planar rays through
    ``intersect_kernel.winner_index``: ``csrc/winner.cu`` on CUDA tensors,
    counted in its launches; its plain version on CPU tensors."""
    return winner_index(gs.counts, *_ray_planes(o, d, tmin, tmax), build_geom_rows(gs).detach())


def closest_index(gs, o, d, tmin, tmax, live=None):
    """Dense grouped winner index i32[R] of planar rays (o, d tuples of
    f32[R]): the BVH walk (``csrc/bvh.cu``) when :func:`use_bvh`, else
    :func:`dense_index`.  `live`, a wavefront bounce's live set, lets the
    walk skip the lanes whose winner cannot change
    (``bvh_kernel.bvh_winner_index``); the dense search takes every lane.
    Piecewise constant, so it carries no gradient."""
    if use_bvh(gs):
        return bvh_winner_index(*_ray_planes(o, d, tmin, tmax), gs.bvh_meta, gs.bvh_aabb,
                                gs.bvh_objs, leaf_size=gs.bvh_dims[1], layout=gs.bvh_layout,
                                live=live)
    return dense_index(gs, o, d, tmin, tmax)


def intersect_and_gather_planar(gs, o, d, tmin, tmax):
    """Closest hit and its record for planar rays: :func:`closest_index`,
    then the record fetch and hit attributes of
    ``planar.gather_epilogue_p``, which is differentiable.  Returns
    (hitrec, mats)."""
    gidx = closest_index(gs, o, d, tmin, tmax)
    return planar.gather_epilogue_p(gs.table_s, gs.table_r, o, d, tmin, tmax, gidx)


# ---- the row-major entry (JAX fast.py:240-502): Rays with origin and dir
# f32[R, 3], as the row-major body carries them


def _planes_of(rays):
    """Row-major rays as the planar (o, d, tmin, tmax) of the winner
    searches; the columns of origin and dir are strided views."""
    return rays.origin.unbind(-1), rays.dir.unbind(-1), rays.tmin, rays.tmax


def _winner_grouped_T(gs, rays):
    """(best t f32[R], dense grouped winner index i32[R]) of row-major
    rays, with the name of the JAX package's XLA search (the object axis
    first, the lowest grouped index winning a tie):
    ``intersect_kernel.winner_t_index_plain``, whose index is
    ``winner_index``'s plain version."""
    with torch.no_grad():
        return winner_t_index_plain(gs.counts, *_ray_planes(*_planes_of(rays)),
                                    build_geom_rows(gs))


def winner_index_rowmajor(gs, rays):
    """Dense grouped winner index i32[R] of row-major rays:
    :func:`dense_index` on their planes, the counterpart of JAX's
    `winner_index_pallas`, which packs the same planes into an [8, R]
    matrix."""
    return dense_index(gs, *_planes_of(rays))


def _gather_epilogue(gs, rays, gidx):
    """The winners' records and hit attributes, differentiable: the rows
    gidx of gs.table_s and gs.table_r, fetched by index_select as
    ``planar.gather_epilogue_p`` fetches them, then `_object_hit_attrs` on
    the gathered geometry.  Returns (Hit, mats) with mats as
    ``bsdf.gather_materials`` returns them."""
    idx = gidx.long()
    rec = gs.table_s.index_select(0, idx)  # [R, F_S]
    rec_r = gs.table_r.index_select(0, idx)  # [R, F_R]
    center, radius, y_pos, height = rec[:, 0:3], rec[:, 3], rec[:, 4], rec[:, 5]
    prim_type = rec[:, 6].to(torch.int32)
    t, normal = _object_hit_attrs(prim_type, center, radius, y_pos, height,
                                  rays.origin, rays.dir, rays.tmin, rays.tmax)
    hit = t < INF
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    hitrec = Hit(
        t=torch.where(hit, t, torch.full_like(t, INF)),
        hit=hit,
        pos=rays.origin + t_safe[:, None] * rays.dir,
        normal=torch.where(hit[:, None], normal, torch.zeros_like(normal)),
        obj_idx=torch.where(hit, rec[:, 12].to(torch.int32), torch.full_like(prim_type, -1)),
    )
    mats = {
        "mat_type": rec[:, 7].to(torch.int32),
        "kd": rec_r[:, 0:3],
        "emission": rec_r[:, 3],
        "smoothness": rec[:, 8],
        "reflectivity": rec[:, 9],
        "ior": rec[:, 10],
        "tex_id": rec[:, 11].to(torch.int32),
        "_geom": (prim_type, center, radius, y_pos, height),
    }
    return hitrec, mats


def intersect_and_gather(gs, rays):
    """Closest hit and its record for row-major rays of one batch axis
    (origin f32[R, 3]): (Hit, mats).  The winner comes from
    :func:`winner_index_rowmajor`, so the tensors' device picks: the
    kernel on CUDA, its plain version on the CPU.  The winner is piecewise
    constant and carries no gradient; the record and attributes
    (:func:`_gather_epilogue`) do.

    Rays with more than one batch axis raise TypeError: the JAX package's
    grouped search takes flat rays only (its `dot_general` fails on them),
    and the row-major body renders a grouped scene's 2-D pixel batch no
    other way."""
    if rays.tmin.dim() != 1:
        raise TypeError(
            f"intersect_and_gather takes rays of one batch axis, got {tuple(rays.tmin.shape)}"
        )
    return _gather_epilogue(gs, rays, winner_index_rowmajor(gs, rays))
