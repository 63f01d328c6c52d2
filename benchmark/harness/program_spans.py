"""The port's own spans (`cpppathtracer_tpu_torch/utils/obs.py`) over the
traced window, for the per-layer readers of the host's time.

The port records a span only while a `torch.profiler` profile runs, so its
store is empty until the pass that records the cards alone begins (set-up
runs unprofiled), and that pass's iterations are the first root calls of
the cell's iteration span; the second pass, which names the idle gaps,
adds its own after them.  A port without spans gives nothing to read.
"""

from __future__ import annotations

SERVE = ("render.call", "viewer.frame")  # one a served iteration: a render, a frame
TRAIN = ("train.step", "mesh.step")  # one a training iteration


def window(view, iteration: tuple):
    """(n, records): the first `trace_iterations` root spans named in
    `iteration`, n of them, and every finished span of the root calls that
    began before the last of them ended (a frame's camera op, a
    `viewer.move`, is a root call of its own); None where the cards did no
    work (no device ran) or no such span was recorded."""
    if view.busy_s <= 0:
        return None
    from cpppathtracer_tpu_torch.utils import obs

    read = getattr(obs, "spans", None)
    if read is None:
        return None
    records = [r for r in read() if r["end_ns"] is not None]
    roots = [r for r in records if r["parent"] == -1]
    its = [r for r in roots if r["name"] in iteration][:int(view.workload["trace_iterations"])]
    if not its:
        return None
    calls = {r["call"] for r in roots if r["start_ns"] <= its[-1]["end_ns"]}
    return len(its), [r for r in records if r["call"] in calls]


def host_ms(view, iteration: tuple, names: tuple):
    """Host milliseconds an iteration inside the spans named in `names`
    (spans that never nest in one another) over the traced window's
    iterations; None where there is nothing to read."""
    got = window(view, iteration)
    if got is None:
        return None
    n, records = got
    inside = [r["end_ns"] - r["start_ns"] for r in records if r["name"] in names]
    return sum(inside) / 1e6 / n if inside else None
