"""The test stand-in for the card's capture backend (``utils/graphs.py``'s
``CudaGraphs``), a module that imports only torch and the port, so that a
spawned rank of tests/test_torch_parallel.py may use it too."""

from cpppathtracer_tpu_torch.ops.cuda import build as kb


class RunBody:
    """Stand-in for ``graphs.CudaGraphs``: a capture runs the body once (as
    ``torch.cuda.graph`` runs it while recording) and its replay runs it
    again with ``build.LAUNCHES`` put back afterwards, since a replay runs
    no Python.  It counts what it was asked to do."""

    def __init__(self):
        self.warmups = self.captured = self.replays = self.released = 0
        self.devices = set()

    def pool(self):
        return None

    def warmup(self, bodies, device):
        for body in bodies:
            body()
        self.warmups += len(bodies)
        self.devices.add(device)

    def capture(self, body, pool, device):
        body()
        self.captured += 1
        self.devices.add(device)
        return Replay(self, body)


class Replay:
    """A stand-in's captured graph: a replay runs the body."""

    def __init__(self, backend, body):
        self.backend, self.body = backend, body

    def replay(self):
        saved = dict(kb.LAUNCHES)
        self.body()
        kb.LAUNCHES.update(saved)
        self.backend.replays += 1

    def reset(self):
        self.backend.released += 1
