"""wavefront_other_ms.frame: device milliseconds a frame outside the port's
hand-written kernels, as `wavefront_other_ms` reads it, in the viewer cells
that report `frame_p95_ms` and not `render_Mrays_s` (whose frame rate
spreads between processes past that metric's bound), so that it moves
`frame_p95_ms` there; nothing where `wavefront_other_ms` reads nothing."""

from benchmark.harness import registry


def read(view):
    return registry.layer_reader("wavefront_other_ms").read(view)
