"""bvh_walk_roofline.frame: kernel #7's share of its roofline over its device
time in the traced window, in %, as `bvh_walk_roofline` reads it, in the
viewer cells that report `frame_p95_ms` and not `render_Mrays_s` (whose
frame rate spreads between processes past that metric's bound), so that it
moves `frame_p95_ms` there; nothing where `bvh_walk_roofline` reads nothing."""

from benchmark.harness import registry


def read(view):
    return registry.layer_reader("bvh_walk_roofline").read(view)
