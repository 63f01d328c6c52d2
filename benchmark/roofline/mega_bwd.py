"""Kernel #8, `mega_bwd_kernel` (csrc/mega_bwd.cu): a sample's backward.
Its bound is the larger of the bytes it must move, 6 ray planes, the pixel
and sample keys, 13 cotangent planes and `depth` winner planes read and 6
planes written, 4 bytes a lane each; and its FP32 operations, 958 per
ray-bounce that hit (the bounce body twice and its adjoint).  The hits come
from the reference's trace of the cell's inputs, counted once at a stated
seed and kept in the cell's workload file (`counts`)."""

OPS_BWD_HIT = 2 * 240 + 330 + 90 + 45 + 13


def bound_s(work: dict, objects: dict, peaks) -> float:
    bytes_ = 4 * work["rays"] * (6 + 2 + 13 + work["depth"] + 6)
    ops = OPS_BWD_HIT * work["hits_per_sample"] * work["samples"]
    return max(bytes_ / peaks.HBM_BYTES_PER_S, ops / peaks.FP32_FLOPS)
