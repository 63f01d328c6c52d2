"""mesh_exchange_ms: host milliseconds a step inside `mesh.exchange` (the
tile mesh's copies across cards and its all-reduces between the replays)."""

from benchmark.harness import program_spans


def read(view):
    return program_spans.host_ms(view, program_spans.TRAIN, ("mesh.exchange",))
