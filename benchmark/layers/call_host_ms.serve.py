"""call_host_ms.serve: host milliseconds an iteration inside the port's
serving entry points (`render.call`, or a frame's `viewer.move` and
`viewer.frame`), from the port's own spans over the traced window."""

from benchmark.harness import program_spans


def read(view):
    return program_spans.host_ms(view, program_spans.SERVE,
                                 ("render.call", "viewer.move", "viewer.frame"))
