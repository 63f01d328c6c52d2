"""Tests of the per-layer readers of the port's own spans
(`benchmark/harness/program_spans.py` and the `layers/` readers built on it)
on hand-built span records in a `TraceView`.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import peaks, registry, trace  # noqa: E402


def _span(name, start_ms, end_ms, parent, call):
    return {"name": name, "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "self_ns": None, "parent": parent, "call": call, "counts": {}}


def _spans_view(busy_s=1.0, iterations=2):
    return trace.TraceView({"busy_s": busy_s, "window_s": 2.0, "cards": 1, "ops": {}}, {}, {},
                           {"trace_iterations": iterations}, registry.roofline, peaks)


def _flight_spans():
    """Three frames of a flight: each a `viewer.move` and a `viewer.frame`
    holding an entry, a copy in and a replay; the third is the labelling
    pass's, after the traced window's two."""
    out = []
    for i, (t0, move_ms, frame_ms, copy_ms) in enumerate(((0.0, 1.0, 3.0, 0.5),
                                                          (5.0, 0.5, 3.5, 0.25),
                                                          (10.0, 1.0, 3.0, 7.0))):
        frame, t1 = len(out) + 1, t0 + move_ms
        out += [_span("viewer.move", t0, t1, -1, 2 * i),
                _span("viewer.frame", t1, t1 + frame_ms, -1, 2 * i + 1),
                _span("graphs.entry", t1 + 0.1, t1 + 0.2, frame, 2 * i + 1),
                _span("graphs.copy_in", t1 + 0.3, t1 + 0.3 + copy_ms, frame, 2 * i + 1),
                _span("graphs.replay", t1 + 2.9, t1 + 3.0, frame, 2 * i + 1)]
    return out


def _mesh_spans():
    """Three sharded steps, the third the labelling pass's: copies in,
    exchanges, the reduce, and an all-reduce exchange of the step's own."""
    out = []
    for i, t0 in enumerate((0.0, 120.0, 240.0)):
        root = len(out)
        out += [_span("mesh.step", t0, t0 + 100.0 + 50 * (i == 2), -1, i),
                _span("graphs.copy_in", t0 + 1, t0 + 3 - i, root, i),
                _span("mesh.exchange", t0 + 5, t0 + 10 - i, root, i),
                _span("graphs.replay", t0 + 10, t0 + 20, root, i),
                _span("mesh.exchange", t0 + 30, t0 + 33 - i, root, i),
                _span("mesh.reduce", t0 + 40, t0 + 41, root, i),
                _span("graphs.replay", t0 + 40.1, t0 + 40.9, root + 5, i)]
    return out


def _grad_spans():
    """Three steps of `bench.train_step_jit`, the third the labelling
    pass's: an entry, a copy in and a replay a step, each a root call of
    its own (the step opens no root span)."""
    out = []
    for i, (t0, copy_ms) in enumerate(((0.0, 2.0), (300.0, 1.0), (600.0, 9.0))):
        out += [_span("graphs.entry", t0, t0 + 1, -1, 3 * i),
                _span("graphs.copy_in", t0 + 1, t0 + 1 + copy_ms, -1, 3 * i + 1),
                _span("graphs.replay", t0 + 12, t0 + 280, -1, 3 * i + 2)]
    return out


@pytest.mark.parametrize("metric,records,want", [
    # (1 + 3) and (0.5 + 3.5) ms of the two traced frames' move and frame
    ("call_host_ms.serve", _flight_spans, 4.0),
    ("copy_in_ms.serve", _flight_spans, (0.5 + 0.25) / 2),
    ("call_host_ms.train", _mesh_spans, 100.0),
    ("copy_in_ms.train", _mesh_spans, (2.0 + 1.0) / 2),
    ("mesh_exchange_ms", _mesh_spans, (5.0 + 3.0 + 4.0 + 2.0) / 2),
    ("call_host_ms.train", lambda: [_span("train.step", 0, 30, -1, 0),
                                    _span("graphs.copy_in", 1, 4, 0, 0),
                                    _span("train.step", 40, 60, -1, 1)], 25.0),
    ("mesh_exchange_ms", lambda: [_span("train.step", 0, 30, -1, 0)], None),
    ("copy_in_ms.serve", lambda: [_span("render.call", 0, 600, -1, 0),
                                  _span("graphs.copy_in", 1, 2.5, 0, 0),
                                  _span("graphs.replay", 3, 4, 0, 0)], 1.5),
    ("call_host_ms.serve", list, None),
    ("copy_in_ms.grad", _grad_spans, (2.0 + 1.0) / 2),
    ("copy_in_ms.grad", lambda: [_span("train.step", 0, 30, -1, 0)], None),
    ("call_host_ms.train", _grad_spans, None),
])
def test_program_span_readers(metric, records, want, monkeypatch):
    """Each reader of the port's spans on hand-built records: the first
    `trace_iterations` iterations, their ms an iteration; nothing without
    device work, without spans, or where the port keeps no store."""
    from cpppathtracer_tpu_torch.utils import obs

    monkeypatch.setattr(obs, "spans", records, raising=False)
    reader = registry.layer_reader(metric)
    got = reader.read(_spans_view())
    assert got == (None if want is None else pytest.approx(want))
    assert reader.read(_spans_view(busy_s=0.0)) is None
    monkeypatch.delattr(obs, "spans")
    assert reader.read(_spans_view()) is None
