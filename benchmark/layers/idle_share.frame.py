"""idle_share.frame: the share of the traced window in which no kernel, memset
or copy ran on the card, in %, as `idle_share.serve` reads it, in the viewer
cells that report `frame_p95_ms` and not `render_Mrays_s` (whose frame rate
spreads between processes past that metric's bound), so that it moves
`frame_p95_ms` there; nothing where `idle_share.serve` reads nothing."""

from benchmark.harness import registry


def read(view):
    return registry.layer_reader("idle_share.serve").read(view)
