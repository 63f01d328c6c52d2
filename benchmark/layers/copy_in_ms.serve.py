"""copy_in_ms.serve: host milliseconds an iteration inside `graphs.copy_in`
(the copies of the caller's tensors into a graph's buffers and the key,
divisor and seed writes beside them), in the serving cells."""

from benchmark.harness import program_spans


def read(view):
    return program_spans.host_ms(view, program_spans.SERVE, ("graphs.copy_in",))
