"""The type-grouped scene tables that every kernel reads (counterpart of
``cpppathtracer_tpu/ops/fast.py:48-126``).

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

import torch

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
    )
