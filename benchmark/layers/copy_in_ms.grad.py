"""copy_in_ms.grad: as `copy_in_ms.train`, a step of `bench.train_step_jit`
(`grad_loop`), which opens no root span of its own: each step copies its
inputs in once, so the step is counted by its `graphs.copy_in` spans."""

from benchmark.harness import program_spans


def read(view):
    return program_spans.host_ms(view, ("graphs.copy_in",), ("graphs.copy_in",))
