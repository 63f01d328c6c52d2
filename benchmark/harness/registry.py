"""Find the benchmark's parts by name.

`BENCHMARK.json` at the root of the checkout lists the cells and metrics.
Each cell is `benchmark/workloads/<cell>.json`; it names its configuration,
`benchmark/configs/<config>.json`, its traffic kind, whose generator is
`benchmark/traffic/<kind>.py`, and its render settings (its own, or one of
its configuration's by name).  A configuration's scene or sky generator
that is not one of the frozen built-ins (`reference/scenes.py`), and the
generator of its albedo textures, is `benchmark/scenes/<generator>.py`.
Each per-layer metric is read by `benchmark/layers/<metric>.py`, and each
kernel's operations and bytes are counted by `benchmark/roofline/<kernel>.py`.
A later change adds a cell, a configuration with its own scene, sky, lens and
textures, a traffic kind, a metric or a kernel by adding such files and
entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def shown(path) -> str:
    """A path as messages give it: from the checkout's root where it lies
    inside it."""
    path = Path(path)
    return str(path.relative_to(ROOT)) if path.is_relative_to(ROOT) else str(path)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{shown(path)} is missing")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(name: str) -> dict:
    w = _json(BENCH_DIR / "workloads" / f"{_name('cell', name)}.json")
    if w.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {w.get('name')!r}")
    return w


def config(name: str) -> dict:
    c = _json(BENCH_DIR / "configs" / f"{_name('config', name)}.json")
    if c.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {c.get('name')!r}")
    return c


def _module(path: Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{shown(path)} is missing")
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    """The generator of a traffic kind: a module with setup(ctx),
    run(state, ctx, seconds=None, iterations=None), release(state, ctx) and
    check(state, ctx)."""
    return _module(BENCH_DIR / "traffic" / f"{_name('traffic', kind)}.py", f"bench_traffic_{kind}")


def scene_part(generator: str, part: str):
    """(function, file) of a configuration's own scene, sky or texture
    generator: `part` ("scene", "sky" or "textures") of
    `benchmark/scenes/<generator>.py`, where scene(**args) gives arrays in
    `reference/scenes.py`'s FIELDS layout, sky(**args) a map f32[H, W, 3]
    and textures(**args) a stack f32[T, H, W, 3]."""
    path = BENCH_DIR / "scenes" / f"{_name('scene', generator)}.py"
    fn = getattr(_module(path, f"bench_scene_{generator}".replace("-", "_").replace(".", "_")),
                 part, None)
    if not callable(fn):
        raise ValueError(f"{shown(path)} has no function {part}(**args)")
    return fn, shown(path)


def layer_reader(metric: str):
    """The reader of a per-layer metric: a module with read(view) -> a
    number, or None where the traced window holds nothing to read."""
    return _module(BENCH_DIR / "layers" / f"{_name('metric', metric)}.py",
                   "bench_layer_" + metric.replace(".", "_").replace("-", "_"))


def roofline(kernel: str):
    """A kernel's operation and byte counts: a module with bound_s(work,
    peaks) -> the least seconds the card could take for that work."""
    return _module(BENCH_DIR / "roofline" / f"{_name('kernel', kernel)}.py",
                   f"bench_roofline_{kernel}")


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that `cell` reports: every
    metric whose `workloads` lists it, or that has no `workloads` key."""
    pick = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]
    return pick(bench["end_to_end"]), pick(bench["per_layer"])
