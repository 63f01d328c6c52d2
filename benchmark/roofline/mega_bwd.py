"""Kernel #8, `mega_bwd_kernel` (csrc/mega_bwd.cu): a sample's backward.
Its bound is the larger of the bytes it must move, 6 ray planes, the pixel
and sample keys, 13 cotangent planes and `depth` winner planes read and 6
planes written, 4 bytes a lane each; and its FP32 operations, 958 per
ray-bounce that hit (the bounce body twice and its adjoint).  The hits come
from the reference's trace of the cell's inputs, counted once at a stated
seed and kept in the cell's workload file (`counts`).

The textured instance, `mega_bwd_kernel<..., true>`, also reads the aux
cotangent planes of every bounce (the hit position and the attenuation
mask: 4 planes a bounce, 281.0 MB a sample at 1024^2 x d8 in all) and
spends 4 more operations a hit; a cell that runs it says so in its
`counts` (`aux_planes_per_bounce`, `aux_ops_per_hit`; 0 where absent)."""

OPS_BWD_HIT = 2 * 240 + 330 + 90 + 45 + 13


def bound_s(work: dict, objects: dict, peaks) -> float:
    planes = 6 + 2 + 13 + work["depth"] + 6 + work.get("aux_planes_per_bounce", 0) * work["depth"]
    ops_hit = OPS_BWD_HIT + work.get("aux_ops_per_hit", 0)
    ops = ops_hit * work["hits_per_sample"] * work["samples"]
    return max(4 * work["rays"] * planes / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_FLOPS)
