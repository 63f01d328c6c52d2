"""The traced window: `torch.profiler` over a few iterations of a cell's
traffic, reduced to device busy time, device time by operation, the idle
gaps by what the host was doing, and the view that per-layer readers read.

Device busy time is the union of the intervals in which a kernel, memset or
copy ran on a card, averaged over the cards used (on one stream it is the
sum of the records, the arithmetic of the port's `bench.profile_busy_ms`).
NCCL's kernels are left out, as there: a collective's kernel occupies the
card from its launch until the last rank joins.
"""

from __future__ import annotations

import contextlib
import json
import re
import tempfile
import time
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPAN_CATS = ("user_annotation",)
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.window"

# The port's hand-written kernels, by CUDA function (csrc/*.cu)
HAND_WRITTEN = ("mega_trace_kernel", "compact_kernel", "expand_kernel", "mega_bwd_kernel",
                "bvh_winner_kernel", "winner_index_kernel", "denoise_kernel")


def function_of(name: str) -> str:
    """A device record's CUDA function, its template arguments and
    parameters left out."""
    m = re.match(r"(?:void )?(?:[\w:]+::)?(\w+)[<(]", name)
    return m.group(1) if m else name


def span(name: str):
    """A host span in the profile (a no-op context when no profiler runs)."""
    from torch.profiler import record_function

    return record_function(name)


def _union(intervals):
    """Merged, sorted intervals of (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: list, window_s: float) -> dict:
    """The traced window's numbers from Chrome-trace events: busy_s (the
    mean over cards of the union of device records inside the window span),
    ops ({CUDA function or op name: device seconds}, summed over cards),
    device_ops and idle_gaps (the ten largest, as [name, seconds])."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"]
    lo, hi = ((win[0]["ts"], win[0]["ts"] + win[0]["dur"]) if win
              else (-float("inf"), float("inf")))
    by_dev, ops = {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if name.startswith("nccl") or "nccl" in name.lower():
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s, t = max(s, lo), min(s + d, hi)
        if t <= s:
            continue
        dev = e.get("args", {}).get("device", 0)
        by_dev.setdefault(dev, []).append((s, t))
        fn = function_of(name)
        ops[fn] = ops.get(fn, 0.0) + (t - s) / 1e6
    merged = {dev: _union(iv) for dev, iv in by_dev.items()}
    busy = [sum(e - s for s, e in m) / 1e6 for m in merged.values()]
    busy_s = sum(busy) / len(busy) if busy else 0.0
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
             for e in events if e.get("cat") in HOST_SPAN_CATS and e.get("ph") == "X"
             and e.get("name") != WINDOW_SPAN]
    calls = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
             for e in events if e.get("cat") in HOST_CALL_CATS and e.get("ph") == "X"]
    gaps = []
    for m in merged.values():
        edges = [lo if win else (m[0][0] if m else 0.0)] + [x for iv in m for x in iv] + [
            hi if win else (m[-1][1] if m else 0.0)]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, _host_at((a + b) / 2, spans, calls)))
    gaps.sort(key=lambda g: -g[0])
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "cards": max(1, len(merged)),
        "ops": ops,
        "device_ops": [[k, v] for k, v in top_ops],
        "idle_gaps": [[name, d / 1e6] for d, name in gaps[:10]],
    }


def _host_at(t: float, spans, calls) -> str:
    """What the host was doing at time t: the innermost benchmark span
    around it, with the CUDA call it was in, if any."""
    inner = [s for s in spans if s[0] <= t <= s[1]]
    call = [c for c in calls if c[0] <= t <= c[1]]
    label = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "outside spans"
    if call:
        label += " / " + call[0][2]
    return label


@contextlib.contextmanager
def profiled(sync, host: bool):
    """Profile the block; yields a dict that holds the reduced trace once
    the block has ended.  With `host` false only the cards' activity is
    recorded, which costs the host little, and busy time is read from it;
    with `host` true the host's operations, spans and CUDA calls are
    recorded too, to name the idle gaps, at a cost to the window.  `sync`
    waits for the cards.  The Chrome trace goes to a temporary directory and
    is deleted once read."""
    from torch.profiler import ProfilerActivity, profile, record_function, supported_activities

    activities = [ProfilerActivity.CPU] if host else []
    if ProfilerActivity.CUDA in supported_activities():
        activities.append(ProfilerActivity.CUDA)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities or [ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            with record_function(WINDOW_SPAN):
                yield out
                sync()
            window_s = time.perf_counter() - t0
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    out.update(reduce_events(events, window_s))


class TraceView:
    """What a per-layer reader reads: the reduced trace, the traffic's work
    in the traced window (samples, live ray-bounces, ...), the cell's
    configuration and workload, and the kernels' roofline counts."""

    def __init__(self, reduced: dict, work: dict, config: dict, workload: dict, roofline, peaks):
        self.busy_s = reduced["busy_s"]
        self.window_s = reduced["window_s"]
        self.cards = reduced["cards"]
        self.ops = reduced["ops"]
        self.work = work
        self.config, self.workload = config, workload
        self.roofline, self.peaks = roofline, peaks

    def counted_work(self) -> dict:
        """The work of the traced window's samples as the cell's `counts`
        give it a sample (counted by the reference's own trace of the
        cell's inputs), with the rays and depth of the window."""
        return {**self.workload["counts"], "samples": self.work["samples"],
                "rays": self.work["rays"], "depth": self.work["depth"]}

    def kernel_s(self, function: str) -> float:
        return self.ops.get(function, 0.0)

    def hand_written_s(self) -> float:
        return sum(self.ops.get(f, 0.0) for f in HAND_WRITTEN)

    def busy_all_s(self) -> float:
        """Device busy seconds summed over the cards."""
        return self.busy_s * self.cards
