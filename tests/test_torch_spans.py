"""The port's spans (``utils/obs.py``): off without a profiler (the shared
no-op, no clock read, nothing kept or allocated), recorded with their
nesting, call ids, counts and self time under ``torch.profiler`` and
stamped into its Chrome trace, the store's bound; and the spans of the
compiled calls through the test stand-in for the capture
(``torch_port_helpers.RunBody``): the render, the progressive frame and the
training step."""

import json
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpppathtracer_tpu_torch.integrator import render_graphed
from cpppathtracer_tpu_torch.inverse import InverseConfig, make_train_step, train_step_graphed
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import SceneBuilder
from cpppathtracer_tpu_torch.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig
from cpppathtracer_tpu_torch.utils import obs
from cpppathtracer_tpu_torch.utils.graphs import GraphedCall, tensors

from torch_port_helpers import RunBody

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_store():
    obs.clear_spans()
    yield
    obs.clear_spans()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def _small(w=8, h=6):
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.3, 0.2))
    b.add_sphere((3.0, 1.0, 1.0), 1.0, kd=(0.3, 0.8, 0.4), emission=1.5)
    cam = Camera.make(w, h, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device="cpu")
    return b.build(device="cpu"), cam, torch.from_numpy(procedural_sky(8, 8, seed=3))


def _named(records, name):
    return [r for r in records if r["name"] == name]


def _nbytes(obj):
    return sum(t.nbytes for t in tensors(obj))


def test_span_off_is_the_shared_noop(monkeypatch):
    """With no profiler recording, a span is the shared OFF whatever its
    counts: it reads no clock, keeps nothing, and allocates nothing."""

    def no_clock():
        raise AssertionError("a span off read the clock")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert obs.span("a") is obs.OFF and obs.span("b", bytes=3) is obs.OFF
    with obs.span("a") as sp:
        sp.count("bytes", 5)
    assert not sp.on and obs.spans() == [] and obs.dropped_spans() == 0

    def loop(n):
        for _ in range(n):
            with obs.span("graphs.replay"):
                pass

    loop(100)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop(10_000)
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current <= base and peak - base < 256, (base, current, peak)


def test_spans_nest_under_the_profiler(tmp_path):
    """Under a CPU profile spans record their parent, their root's call id,
    their counts and their self time (their time outside their child
    spans), and appear in the Chrome trace as user annotations."""
    with recording() as prof:
        with obs.span("outer", replays=2) as outer:
            with obs.span("inner") as inner:
                inner.count("tensors")
                inner.count("bytes", 12)
                inner.count("bytes", 4)
                torch.ones(4).sum()
            with obs.span("inner"):
                time.sleep(0.001)
            outer.count("replays", 1)
        with obs.span("next"):
            pass
    recs = obs.spans()
    assert [r["name"] for r in recs] == ["outer", "inner", "inner", "next"]
    assert [r["parent"] for r in recs] == [-1, 0, 0, -1]
    assert recs[0]["call"] == recs[1]["call"] == recs[2]["call"] != recs[3]["call"]
    assert recs[0]["counts"] == {"replays": 3} and recs[1]["counts"] == {"tensors": 1, "bytes": 16}
    dur = [r["end_ns"] - r["start_ns"] for r in recs]
    assert recs[0]["self_ns"] == dur[0] - dur[1] - dur[2] and recs[0]["self_ns"] >= 0
    assert [r["self_ns"] for r in recs[1:]] == dur[1:] and dur[2] >= 1_000_000
    assert recs[1]["start_ns"] >= recs[0]["start_ns"] and recs[2]["end_ns"] <= recs[0]["end_ns"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(names) == ["inner", "inner", "next", "outer"]
    assert obs.span("after") is obs.OFF


def test_store_drops_past_its_bound(monkeypatch):
    """Past its limit the store keeps no more records and counts each one
    dropped; a span inside a dropped one still takes its root's call id."""
    monkeypatch.setattr(obs, "_SPANS", obs.SpanStore(limit=3))
    with recording():
        with obs.span("a"):
            with obs.span("b"):
                pass
        with obs.span("c"):
            with obs.span("d") as d:
                pass
            with obs.span("e"):
                pass
    assert [r["name"] for r in obs.spans()] == ["a", "b", "c"]
    assert obs.dropped_spans() == 2
    assert d.index == -1 and d.parent == 2 and d.call == obs.spans()[2]["call"]
    obs.clear_spans()
    assert obs.spans() == [] and obs.dropped_spans() == 0


def test_render_spans_miss_then_hit():
    """A compiled render records `render.call` around one `graphs.entry`
    miss that holds the one `graphs.capture` of its bodies, a
    `graphs.copy_in` that counts the tensors copied and their bytes, and a
    `graphs.replay` a graph replayed; the next call hits and captures
    nothing.  All share their render's call id."""
    scene, cam, sky = _small()
    runner = GraphedCall(backend=RunBody())
    with recording():
        for _ in range(2):
            render_graphed(runner, scene, cam, sky, spp=2, max_depth=2)
    recs = obs.spans()
    calls = _named(recs, "render.call")
    assert len(calls) == 2 and all(r["parent"] == -1 for r in calls)
    assert [r["counts"] for r in calls] == [{"replays": 2}] * 2
    entries = _named(recs, "graphs.entry")
    assert [r["counts"] for r in entries] == [{"hit": 0}, {"hit": 1}]
    (cap,) = _named(recs, "graphs.capture")
    assert cap["counts"] == {"bodies": 2}
    assert recs[cap["parent"]]["name"] == "graphs.entry" and cap["call"] == calls[0]["call"]
    copies = _named(recs, "graphs.copy_in")
    inputs = (scene, cam, sky)
    assert [r["counts"] for r in copies] == [
        {"tensors": len(tensors(inputs)), "bytes": _nbytes(inputs)}] * 2
    replays = _named(recs, "graphs.replay")
    assert len(replays) == 4 and all(r["counts"] == {"card": 0} for r in replays)
    for r in recs:
        assert r["call"] in (calls[0]["call"], calls[1]["call"]) and r["end_ns"] is not None
    assert all(r["parent"] != -1 for r in recs if r["name"].startswith("graphs."))


def test_viewer_spans_count_the_mix_copy():
    """The progressive frame's `viewer.frame` holds its entry, its copy in
    and its replay.  The caller's mix is copied into the graph's buffer
    where it is another tensor: on the first frame and after a camera op
    (a `viewer.move` of its own), whose refresh makes a new mix; a frame
    that goes on accumulating reads the buffer itself and copies one
    tensor fewer."""
    scene, cam, sky = _small()
    r = ProgressiveRenderer(scene, cam, sky, RenderConfig(width=8, height=6, max_depth=2))
    r.graphs = GraphedCall(backend=RunBody())
    with recording():
        r.step_graphed()
        r.step_graphed()
        r.move_camera(Camera.move_forward, 0.5)
        r.step_graphed()
    recs = obs.spans()
    assert [x["name"] for x in recs if x["parent"] == -1] == [
        "viewer.frame", "viewer.frame", "viewer.move", "viewer.frame"]
    copies = [x["counts"]["tensors"] for x in _named(recs, "graphs.copy_in")]
    n_in = len(tensors((scene, cam, sky)))
    assert copies == [n_in + 1, n_in, n_in + 1]
    assert len(_named(recs, "graphs.capture")) == 1 and len(_named(recs, "graphs.replay")) == 3


def test_train_step_spans():
    """The compiled training step records `train.step` around its entry,
    its copy in (parameters, Adam state, scene, sky, target, camera) and
    its replay; the copy back lies in the step's own time."""
    scene, cam, sky = _small()
    target = torch.rand(cam.height * cam.width, 3, generator=torch.Generator().manual_seed(1))
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd", "emission"))
    init, _ = make_train_step(cam, cfg)
    params, opt = init(scene, sky)
    runner = GraphedCall(backend=RunBody())
    with recording():
        for step in range(2):
            params, opt, _ = train_step_graphed(runner, cam, cfg, params, opt, scene, sky, target,
                                                step)
    recs = obs.spans()
    steps = _named(recs, "train.step")
    assert len(steps) == 2 and [x["name"] for x in recs if x["parent"] == -1] == ["train.step"] * 2
    copied = (params, opt, (scene, sky, target, cam))
    assert [x["counts"] for x in _named(recs, "graphs.copy_in")] == [
        {"tensors": len(tensors(copied)), "bytes": _nbytes(copied)}] * 2
    assert [x["counts"] for x in _named(recs, "graphs.entry")] == [{"hit": 0}, {"hit": 1}]
    for s in steps:
        inside = [x for x in recs if x["call"] == s["call"] and x is not s]
        assert sum(x["end_ns"] - x["start_ns"] for x in inside if recs[x["parent"]] is s) == (
            s["end_ns"] - s["start_ns"] - s["self_ns"])
