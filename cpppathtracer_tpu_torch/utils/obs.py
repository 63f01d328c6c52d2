"""Observability: logging, phase timing, throughput, metrics and profiler
traces (counterpart of ``cpppathtracer_tpu/utils/obs.py``).

The logger prefixes lines with [time][level][file:line], as the
reference's file logger does (`include/logger.hpp:12-80`).  A phase timer
waits for the device that holds its result before it reads the clock,
since PyTorch returns before a CUDA kernel ends.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import torch

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


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """torch.profiler over the block, host activity and, where a card is
    present, its device activity; the Chrome trace is written to
    ``<log_dir>/trace.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
