"""Observability: logging, phase timing, throughput, metrics and spans
(counterpart of ``cpppathtracer_tpu/utils/obs.py``).

The logger prefixes lines with [time][level][file:line], as the
reference's file logger does (`include/logger.hpp:12-80`).  A phase timer
waits for the device that holds its result before it reads the clock,
since PyTorch returns before a CUDA kernel ends.

Spans (:func:`span`) mark the host's time at the boundaries of the
compiled calls while a ``torch.profiler`` profile records, and cost one
flag read otherwise.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler

from cpppathtracer_tpu_torch.utils.checkpoint import flatten

_FMT = "[%(asctime)s][%(levelname)s][%(filename)s:%(lineno)d] %(message)s"


def get_logger(name: str = "poca_torch", log_dir: str | None = None) -> logging.Logger:
    """Console and file logger; the file is
    ``<log_dir>/cpppathtracer_tpu_torch.log``, log_dir defaulting to
    POCA_LOG_DIR or ``./logs``.  The handlers are made on the first call
    for a name."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(sh)
    log_dir = log_dir or os.environ.get("POCA_LOG_DIR", "./logs")
    try:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "cpppathtracer_tpu_torch.log"))
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    except OSError:
        pass
    return logger


def wait_for(tree) -> None:
    """Wait until the CUDA devices holding the tensors of `tree` (a tensor,
    or a tree of them, ``utils/checkpoint.py``) have finished their queued
    work."""
    for dev in {t.device for t in flatten(tree)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock timer (timer.hpp analog) that waits for the device."""

    @staticmethod
    def now_ms() -> float:
        return time.time() * 1000.0

    @staticmethod
    @contextlib.contextmanager
    def phase(name: str, sink: dict | None = None):
        """Times the block; put its result in the yielded dict under
        "result" and the clock stops only once the result's devices are
        done."""
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "result" in holder:
                wait_for(holder["result"])
            dt = time.perf_counter() - t0
            if sink is not None:
                sink[name] = sink.get(name, 0.0) + dt


class RaysPerSecond:
    """Running throughput meter (W * H * spp * depth rays per second)."""

    def __init__(self):
        self.total_rays = 0
        self.total_seconds = 0.0

    def add(self, width: int, height: int, spp: int, max_depth: int, seconds: float):
        self.total_rays += width * height * spp * max_depth
        self.total_seconds += seconds

    @property
    def rays_per_sec(self) -> float:
        return self.total_rays / self.total_seconds if self.total_seconds else 0.0

    def report(self) -> dict:
        return {
            "rays": self.total_rays,
            "seconds": self.total_seconds,
            "rays_per_sec": self.rays_per_sec,
        }


class MetricsLog:
    """Append-only JSONL metrics (per-step loss, rays/s and the like)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, **kv):
        kv.setdefault("t", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(kv) + "\n")


# ---- spans

SPAN_LIMIT = 1 << 16


class _Off:
    """The span of a call that no profiler records: one shared object that
    does nothing."""

    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, key: str, n: int = 1):
        pass


OFF = _Off()


class SpanStore:
    """The spans recorded so far, at most `limit` of them; past it a span
    is dropped, and counted in `dropped`."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self.limit = limit
        self.records: list = []
        self.dropped = 0
        self.calls = itertools.count()
        self.local = threading.local()  # each thread's open spans, innermost last


class Span:
    """One recorded span: its name, its start and end (``time.
    perf_counter_ns``), its place in the store (`index`, -1 when dropped),
    the index of the span it lies in (`parent`, -1 at a root), the call id
    its root took (`call`), the time its child spans took (`child_ns`) and
    its counts."""

    __slots__ = ("name", "counts", "index", "parent", "call", "start_ns", "end_ns", "child_ns",
                 "_annotation")
    on = True

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts
        self.end_ns = None
        self.child_ns = 0

    def count(self, key: str, n: int = 1):
        """Add n to the count `key`."""
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self):
        store = _SPANS
        stack = store.local.__dict__.setdefault("open", [])
        outer = stack[-1] if stack else None
        self.parent = outer.index if outer is not None else -1
        self.call = outer.call if outer is not None else next(store.calls)
        if len(store.records) < store.limit:
            self.index = len(store.records)
            store.records.append(self)
        else:
            self.index = -1
            store.dropped += 1
        stack.append(self)
        # the profiler's annotation stamps the span on the device trace's clock
        self._annotation = _profiler.record_function(self.name)
        self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._annotation.__exit__(*exc)
        self._annotation = None
        stack = _SPANS.local.open
        stack.pop()
        if stack:
            stack[-1].child_ns += self.end_ns - self.start_ns
        return None


_SPANS = SpanStore()


def span(name: str, **counts):
    """A span of the host's time named `name`, with `counts` (ints; more
    through ``.count(key, n)``), as a context.  Only while a
    ``torch.profiler`` profile records: the span then enters the profile
    as a ``record_function`` annotation, so it shares the device trace's
    clock, and is kept in the store that :func:`spans` reads.  Otherwise
    the shared :data:`OFF`: no clock is read and nothing is kept.  Never
    put a span inside a captured body: it would run at capture only."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, counts)


def spans() -> list:
    """The recorded spans in the order they began, as dicts: name,
    start_ns, end_ns (None while open), self_ns (the time outside its
    child spans), parent (the index of the span it lies in, -1 at a root),
    call (its root's call id, shared by every span of one root call) and
    counts."""
    out = []
    for s in _SPANS.records:
        done = s.end_ns is not None
        out.append({"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "self_ns": s.end_ns - s.start_ns - s.child_ns if done else None,
                    "parent": s.parent, "call": s.call, "counts": dict(s.counts)})
    return out


def dropped_spans() -> int:
    """The spans dropped since the store was last cleared, the store being
    full."""
    return _SPANS.dropped


def clear_spans():
    """Empty the store of spans."""
    _SPANS.records.clear()
    _SPANS.dropped = 0
