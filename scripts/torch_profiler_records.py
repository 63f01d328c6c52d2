"""How many of a run's kernel launches torch.profiler keeps a device record
of, and which ones it loses, on one NVIDIA card.

    python3 scripts/torch_profiler_records.py [--calls 200] [--out FILE]

Three workloads, each profiled as ``chip_smoke.device_ms`` profiles (CPU
and CUDA activities, the calls, a synchronize):

  denoise   the denoise kernel on a 1280x720 frame, one launch a call
  add       an in-place add on 2^20 floats, one launch a call
  mixed     eight PyTorch elementwise launches a call over 2^20 floats

For each it exports the profile's Chrome trace and pairs every launch the
runtime recorded (``cudaLaunchKernel`` and kin, by correlation id) with the
device's record of that kernel.  It prints the launches counted by the
host, the launches with a runtime record, the device records in the trace,
the positions (in launch order) of the launches with no device record, so
that a loss at the start, at the end or spread through the run shows
apart, and the device records that ``key_averages()`` of the same profile
counts; then the same with the profiler's schedule warming up one call's
worth before the calls it keeps (``schedule(wait=0, warmup=1, active=1)``).
It prints the card's name and power limit and keeps everything as JSON with
`--out`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def workloads(dev):
    """{name: (fn, device launches a call)}."""
    import torch

    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise

    g = torch.Generator(device=dev).manual_seed(0)
    rad = 2 * torch.rand((720, 1280, 3), device=dev, generator=g)
    nrm = torch.randn((720, 1280, 3), device=dev, generator=g)
    dep = 50 * torch.rand((720, 1280), device=dev, generator=g)
    x = torch.rand(1 << 20, device=dev, generator=g)
    y = torch.rand(1 << 20, device=dev, generator=g)

    def mixed():
        a = x * y
        b = a + x
        c = b.exp()
        d = c - y
        e = d.abs()
        f = e.sqrt()
        h = f.mul_(2.0)
        return h.add_(1.0)

    return {"denoise": (lambda: denoise(rad, nrm, dep, 1), 1),
            "add": (lambda: x.add_(1.0), 1),
            "mixed": (mixed, 8)}


def pair_records(trace_path):
    """(runtime launches in order of correlation id, {correlation: kernel
    name} of the device records) from a Chrome trace."""
    ev = json.loads(Path(trace_path).read_text())["traceEvents"]
    launches = sorted(e["args"]["correlation"] for e in ev
                      if e.get("cat") == "cuda_runtime" and e.get("name") in LAUNCH_CALLS
                      and "correlation" in e.get("args", {}))
    kernels = {e["args"]["correlation"]: e["name"] for e in ev
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    return launches, kernels


def averaged_records(prof):
    """The device records that key_averages() counts."""
    import torch

    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def profile_once(fn, calls, warmup, tmp):
    """(runtime launches, {correlation: kernel}, key_averages' device
    records) of one profile of `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    path = Path(tmp) / "trace.json"
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    averaged = []
    if warmup:
        def ready(p):
            p.export_chrome_trace(str(path))
            averaged.append(averaged_records(p))

        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
    else:
        with profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        averaged.append(averaged_records(prof))
    return (*pair_records(path), averaged[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_profiler_records: no CUDA device; nothing was run")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    report = {"card": smi, "torch": torch.__version__, "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fn, per_call) in workloads(dev).items():
            fn()
            torch.cuda.synchronize()
            for warmup in (False, True):
                for rep in range(args.repeats):
                    launches, kernels, averaged = profile_once(fn, args.calls, warmup, tmp)
                    lost = [i for i, c in enumerate(launches) if c not in kernels]
                    run = dict(workload=name, warmup=warmup, repeat=rep,
                               host_launches=args.calls * per_call,
                               runtime_records=len(launches), device_records=len(kernels),
                               paired=len(launches) - len(lost), lost_positions=lost,
                               key_averages_records=averaged)
                    report["runs"].append(run)
                    print(f"[records] {name} warmup={warmup} #{rep}: host "
                          f"{run['host_launches']}, runtime {run['runtime_records']}, device "
                          f"{run['device_records']}, paired {run['paired']}, key_averages "
                          f"{averaged}; unpaired at "
                          f"{lost[:40]}{' ...' if len(lost) > 40 else ''}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
