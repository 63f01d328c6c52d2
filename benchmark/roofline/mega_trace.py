"""Kernel #1, `mega_trace_kernel` (csrc/mega_trace.cu): the megakernel's
bounces.  Its bound counts the work the cell's inputs need, whatever does
it: FP32 operations per live ray-bounce (a ray is traced at bounce b while
every earlier bounce hit), per object tested by type plus the bounce body,
as the winner search and the bounce body of the reference's `object.cu` and
`material.cu` need them (33 a sphere, 10 a platform, 87 a cylinder, 240 the
bounce; an FMA counts two, as the FP32 peak does); and the bytes of the
ray planes read and written, at least 4 * R * (27 + 12 + depth) a sample.
The live ray-bounces come from the reference's own trace of the cell's
inputs, counted once at a stated seed and kept in the cell's workload file
(`counts`)."""

OPS_SPHERE, OPS_PLATFORM, OPS_CYLINDER, OPS_RAY_BOUNCE = 33, 10, 87, 240


def ops_per_live_ray_bounce(objects: dict) -> int:
    return (OPS_SPHERE * objects["spheres"] + OPS_PLATFORM * objects["platforms"]
            + OPS_CYLINDER * objects["cylinders"] + OPS_RAY_BOUNCE)


def bound_s(work: dict, objects: dict, peaks) -> float:
    """The least seconds on the card for `work`: `samples` samples of
    `live_ray_bounces_per_sample` each, `rays` rays in all, `depth`."""
    ops = ops_per_live_ray_bounce(objects) * work["live_ray_bounces_per_sample"] * work["samples"]
    bytes_ = 4 * work["rays"] * (27 + 12 + work["depth"])
    return max(ops / peaks.FP32_FLOPS, bytes_ / peaks.HBM_BYTES_PER_S)
