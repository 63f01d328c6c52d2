"""copy_in_ms.frame: host milliseconds a frame inside `graphs.copy_in`, as
`copy_in_ms.serve` reads it, in the viewer cells that report `frame_p95_ms`
and not `render_Mrays_s` (whose frame rate spreads between processes past
that metric's bound), so that it moves `frame_p95_ms` there; nothing where
`copy_in_ms.serve` reads nothing."""

from benchmark.harness import registry


def read(view):
    return registry.layer_reader("copy_in_ms.serve").read(view)
