"""call_host_ms.frame: host milliseconds a frame inside the port's serving
entry points (`viewer.move` and `viewer.frame`), as `call_host_ms.serve`
reads it, in the viewer cells that report `frame_p95_ms` and not
`render_Mrays_s` (whose frame rate spreads between processes past that
metric's bound), so that it moves `frame_p95_ms` there; nothing where
`call_host_ms.serve` reads nothing."""

from benchmark.harness import registry


def read(view):
    return registry.layer_reader("call_host_ms.serve").read(view)
