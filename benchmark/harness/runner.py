"""One run of one cell: load, warm up, measure, check, print one line.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout.  With `--trace 0` the window
measures the cell's end-to-end metrics for `--seconds` seconds; with
`--trace 1` a few iterations of the same traffic run under `torch.profiler`
recording the cards alone, and the cell's per-layer metrics are read from
that trace; a second pass, recording the host too, only names the idle gaps
of `breakdown`.  Either way the
outputs of the timed path are then compared with the plain reference
(`benchmark/reference/`), and the last line of standard output is one JSON
object: correct, attempted, failed, metrics, device (and breakdown when
traced), setup_phases (the host-clock seconds of each phase of set-up),
then checks, each number compared beside its limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

from benchmark.harness import peaks, registry, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "cpppathtracer_tpu")
CACHE_DIR = registry.ROOT / "cpppathtracer_tpu_torch" / "_build"


class NoCard(SystemExit):
    pass


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is JAX, its libraries or the JAX package."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What a traffic kind is given: the cell, its configuration and its
    render settings, the seed, the window and where it runs."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    devices: list
    settings: dict = dataclasses.field(default_factory=dict)
    phases: dict = dataclasses.field(default_factory=dict)
    mark_t: float = 0.0

    def mark(self, phase: str):
        """Charge the host-clock time since the last mark to `phase` of
        set-up."""
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + (now - self.mark_t)
        self.mark_t = now

    @property
    def device(self):
        return self.devices[0]

    def sync(self):
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def memory_peak_bytes(self) -> int:
        import torch

        cards = [d for d in self.devices if d.type == "cuda"]
        return max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)


def cache_env():
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def cards(n: int):
    """The first n CUDA devices; raises NoCard (exit 2, no result) when
    there is no card or fewer than n."""
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: no result")
        raise NoCard(2)
    if torch.cuda.device_count() < n:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {n}: no result")
        raise NoCard(2)
    return [torch.device("cuda", i) for i in range(n)]


def power_limit(index: int = 0) -> str:
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return lines[index].strip() if index < len(lines) else "not read"


def make_context(cell: str, seed: int, seconds: float, trace_on: bool, devices) -> Context:
    wl = registry.workload(cell)
    cfg = registry.config(wl["config"])
    return Context(cell=cell, workload=wl, config=cfg, seed=int(seed), seconds=float(seconds),
                   trace=trace_on, devices=list(devices),
                   settings=dict(cfg["settings"][wl["settings"]]))


def run_cell(ctx: Context, t0: float, bench: dict) -> dict:
    """Set up, measure (or trace), free the program, check; returns the
    result line as a dict."""
    import torch

    if not ctx.mark_t:
        ctx.mark_t = time.perf_counter()
    for d in ctx.devices:
        if d.type == "cuda":
            torch.zeros(1, device=d)  # the allocator's statistics exist once a device is used
            torch.cuda.reset_peak_memory_stats(d)
    ctx.mark("cards")
    if ctx.device.type == "cuda":
        from cpppathtracer_tpu_torch.ops.cuda import build

        build.library()
        ctx.mark("library")
    kind = registry.traffic(ctx.workload["traffic"])
    e2e_defs, layer_defs = registry.cell_metrics(bench, ctx.cell)
    log(f"{ctx.cell}: set-up")
    state = kind.setup(ctx)
    ctx.sync()
    ctx.mark("sync")
    setup_s = time.perf_counter() - t0
    log(f"{ctx.cell}: set-up {setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in ctx.phases.items()) + "); window")
    reduced = None
    if ctx.trace:
        n = int(ctx.workload["trace_iterations"])
        with trace.profiled(ctx.sync, host=False) as reduced:
            out = kind.run(state, ctx, iterations=n)
        # the host's activity, recorded in a pass of its own, names the idle gaps
        with trace.profiled(ctx.sync, host=True) as labelled:
            kind.run(state, ctx, iterations=int(ctx.workload.get("label_iterations", n)))
        reduced["idle_gaps"] = labelled["idle_gaps"]
    else:
        out = kind.run(state, ctx, seconds=ctx.seconds)
    peak = ctx.memory_peak_bytes()
    log(f"{ctx.cell}: {out['iterations']} iterations in {out['elapsed_s']:.3f} s; check")
    kind.release(state, ctx)
    checks = kind.check(state, ctx)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}")
        raise SystemExit(3)
    metrics = {}
    if ctx.trace:
        view = trace.TraceView(reduced, out["work"], ctx.config, ctx.workload, registry.roofline,
                               peaks)
        for m in layer_defs:
            value = registry.layer_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(out["e2e"], setup_s=setup_s)
        for m in e2e_defs:
            if m["name"] not in e2e:
                raise KeyError(f"{ctx.cell}'s traffic does not give {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    failed = sum(1 for c in checks["numbers"] if not c["value"] <= c["limit"])
    card = ctx.device.type == "cuda"
    device = {"platform": "gpu" if card else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if card else "cpu",
              "count": len(ctx.devices), "memory_peak_bytes": int(peak),
              "power_limit": power_limit() if card else "none"}
    line = {"correct": failed == 0 and checks["answered"], "attempted": int(out["iterations"]),
            "failed": int(checks.get("failed_answers", failed)), "metrics": metrics,
            "device": device}
    if ctx.trace:
        device["busy_s"] = reduced["busy_s"]
        device["window_s"] = reduced["window_s"]
        line["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    line["setup_phases"] = dict(ctx.phases)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks["numbers"]}
    return line


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: float | None = None, devices=None) -> int:
    """Run one cell; `devices` replaces the look for cards (the harness's
    tests run the rest of a run on the CPU)."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cache_env()
    import torch  # noqa: F401

    import cpppathtracer_tpu_torch  # noqa: F401
    phases = {"imports": time.perf_counter() - t0}
    bench = registry.benchmark()
    wl = registry.workload(args.workload)
    if devices is None:
        try:
            devices = cards(int(wl["chips"]))
        except NoCard as e:
            return int(e.code)
    ctx = make_context(args.workload, args.seed, args.seconds, bool(args.trace), devices)
    ctx.phases, ctx.mark_t = phases, t0 + phases["imports"]
    line = run_cell(ctx, t0, bench)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
