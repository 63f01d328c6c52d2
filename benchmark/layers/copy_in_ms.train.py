"""copy_in_ms.train: as `copy_in_ms.serve`, a training step."""

from benchmark.harness import program_spans


def read(view):
    return program_spans.host_ms(view, program_spans.TRAIN, ("graphs.copy_in",))
