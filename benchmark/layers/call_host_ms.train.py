"""call_host_ms.train: as `call_host_ms.serve`, inside the training entry
points (`train.step`, `mesh.step`), a step."""

from benchmark.harness import program_spans


def read(view):
    return program_spans.host_ms(view, program_spans.TRAIN, program_spans.TRAIN)
