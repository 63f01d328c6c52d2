"""Benchmark: rays/s forward+backward of the training step (counterpart of
the root ``bench.py``), on the CUDA card unless --device says otherwise:

    python -m cpppathtracer_tpu_torch bench [--device cpu]
    python bench_torch.py [--device cpu]

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "rays/s", "device": "<name>, <power limit>"}

The metric is differentiable-render throughput (forward + material-
parameter backward) on ``demo_scene(0)`` at 1024x1024 x 64 spp x depth 8,
rays counted as W x H x spp x depth, as ``bench.py:83-84`` counts them.
With ``--device cpu`` it runs the smoke size 64x64 x 2 spp x depth 4
(the JAX bench's CPU size).  On the card the step is compiled, one CUDA
graph (:func:`train_step_jit`), as ``bench.py`` jits its step; the first
call, which builds the kernels and captures the graph, is reported apart
from the timed steps.  Progress lines go to stderr.

Unlike ``bench.py`` there is no ``vs_baseline``: its denominator,
``BASELINE_RAYS_PER_SEC = 1e9``, is a target set for a TPU v5p-16, and
the port states no number taken on or for a TPU.  Nor does the port fall
back to the CPU on its own: without a card and without ``--device`` it
raises (``types.resolve_device``).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import torch

from cpppathtracer_tpu_torch.types import resolve_device
from cpppathtracer_tpu_torch.utils import obs
from cpppathtracer_tpu_torch.utils.graphs import (
    Entry,
    GraphedCall,
    copy_into,
    env_switches,
    signature,
    static_twin,
)

CAMERA = dict(origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))


def train_step(scene, camera, sky, spp, max_depth, tex_stack=None):
    """``bench.py``'s step (``bench.py:42-54``): the loss ``sum(rad^2)`` of
    ``render_radiance(..., seed=0)`` and its gradients w.r.t. kd and
    emission, and w.r.t. the texture stack when one is given.  Returns
    (loss, grads), grads a dict keyed "kd", "emission" (and "tex_stack")."""
    from cpppathtracer_tpu_torch.integrator import render_radiance

    leaves = {"kd": scene.kd.clone().requires_grad_(),
              "emission": scene.emission.clone().requires_grad_()}
    if tex_stack is not None:
        leaves["tex_stack"] = tex_stack.clone().requires_grad_()
    s = scene.with_material_params({"kd": leaves["kd"], "emission": leaves["emission"]})
    rad, _, _ = render_radiance(s, camera, sky, spp=spp, max_depth=max_depth, seed=0,
                                tex_stack=leaves.get("tex_stack"))
    loss = (rad * rad).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# The CUDA graphs of train_step_jit, as jax.jit caches its programs: a few
# keys, least recently used first out; BENCH_GRAPHS.clear() frees them.
BENCH_GRAPHS = GraphedCall(max_entries=2)


def train_step_jit(scene, camera, sky, spp, max_depth, tex_stack=None):
    """:func:`train_step` compiled, the counterpart of ``bench.py:53``'s
    ``jax.jit(jax.value_and_grad(loss_fn))``: same arguments, same
    (loss, grads).

    On the card, one CUDA graph of the whole step (ray generation, every
    sample's forward and backward, the gradients as outputs of
    ``torch.autograd.grad``) is captured once per key of
    :data:`BENCH_GRAPHS` (every input's shape and dtype, spp, max_depth
    and the POCA_* switches) and replayed; the scene, camera, sky and
    textures are copied into its buffers first, and the results returned
    are copies of its outputs.  Its memory holds the step's whole tape, as
    JAX's program holds every sample's residuals.  A capture that fails
    raises.  On the CPU it is :func:`train_step`."""
    if scene.device.type == "cpu":
        return train_step(scene, camera, sky, spp, max_depth, tex_stack=tex_stack)
    return train_step_graphed(BENCH_GRAPHS, scene, camera, sky, spp, max_depth, tex_stack)


def bench_key(scene, camera, sky, spp, max_depth, tex_stack=None):
    """The cache key of :func:`train_step_jit`'s graphs for these arguments."""
    return ("bench", signature((scene, camera, sky, tex_stack)), spp, max_depth, env_switches())


def train_step_graphed(runner: GraphedCall, scene, camera, sky, spp, max_depth, tex_stack=None):
    """:func:`train_step_jit`'s body on the graphs of `runner` (its capture
    backend decides what a capture is)."""
    inputs = (scene, camera, sky, tex_stack)
    e = runner.entry(lambda: bench_key(scene, camera, sky, spp, max_depth, tex_stack),
                     lambda r: _capture_bench(r, inputs, spp, max_depth))
    with obs.span("graphs.copy_in") as sp:
        copy_into(e.inputs, inputs, sp)
    e.graphs[0].replay()
    loss, grads = e.out
    return loss.clone(), {k: g.clone() for k, g in grads.items()}


def _capture_bench(runner, inputs, spp, max_depth):
    """The entry of one bench key: static scene, camera, sky and textures,
    and the graph of :func:`train_step` on them."""
    e = Entry()
    e.inputs = static_twin(inputs)
    scene, camera, sky, tex_stack = e.inputs

    def body():
        e.out = train_step(scene, camera, sky, spp, max_depth, tex_stack=tex_stack)

    e.graphs = runner.capture(body, device=scene.device)
    return e


def build_bench(width, height, spp, max_depth, device=None):
    """What ``bench.py:31-54`` builds: ``demo_scene(0)`` (93 objects), the
    bench camera at (130, 103, 130), a 256x256 procedural sky, all on
    `device` (default the card), and the step.  Returns (step, scene,
    camera, sky); ``step()`` runs :func:`train_step_jit` on them (on the
    card the compiled step, as ``bench.py`` jits its step)."""
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky

    dev = resolve_device(device)
    scene = demo_scene(seed=0).build(device=dev)
    camera = Camera.make(width, height, device=dev, **CAMERA)
    sky = torch.from_numpy(procedural_sky(256, 256)).to(dev)
    step = functools.partial(train_step_jit, scene, camera, sky, spp, max_depth)
    return step, scene, camera, sky


def device_label(dev) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them;
    "cpu" for the CPU."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index < len(lines):
        return lines[index].strip()
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def profile_busy_ms(fn, device=None):
    """Device busy ms of one call of fn() under torch.profiler: the summed
    device time of the kernels, memsets and copies it issues, on the card
    `device` alone when it names one by index, else on every card; 0.0
    when the profile holds no device event there (the tracing dropped
    out).  NCCL's kernels are left out: a collective's kernel occupies the
    card from its launch until the last rank joins, so its device time
    holds the other ranks' lateness.  The profile closes after a
    synchronize of `device` (the current card by default); fn waits for
    any other card it uses."""
    from torch.profiler import ProfilerActivity, profile

    index = None if device is None else torch.device(device).index
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (index is None or e.device_index == index)
               and not e.name.startswith("nccl")) / 1e3


def busy_ms(fn, device=None, attempts=3):
    """:func:`profile_busy_ms`, taken again while a profile holds no device
    time, up to `attempts` profiles."""
    for _ in range(attempts):
        busy = profile_busy_ms(fn, device)
        if busy > 0:
            return busy
    raise RuntimeError("torch.profiler recorded no device time")


def main(argv=None):
    p = argparse.ArgumentParser(prog="bench", description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions "
                        "at the smoke size)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        width = height = 1024
        spp, max_depth = 64, 8
    else:  # CPU smoke size
        width = height = 64
        spp, max_depth = 2, 4
    label = device_label(dev)
    sync = functools.partial(torch.cuda.synchronize, dev) if on_card else (lambda: None)

    step, _, _, _ = build_bench(width, height, spp, max_depth, dev)
    if on_card:
        # from here, so that the peak covers the capture: the graph holds the step's tape,
        # and its replays allocate nothing
        torch.cuda.reset_peak_memory_stats(dev)
    # warm-up; the first call on the card also builds the kernels (nvcc) and captures
    # the step's graph
    t0 = time.perf_counter()
    step()
    sync()
    first_s = time.perf_counter() - t0
    print(f"[bench] device={dev} ({label}) first={first_s:.1f}s", file=sys.stderr)

    iters = 3 if on_card else 1
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        loss, _ = step()
        sync()
        times.append(time.perf_counter() - t0)
    dt = sum(times) / iters

    rays = width * height * spp * max_depth
    rays_per_sec = rays / dt
    peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if on_card else "")
    print(
        f"[bench] {width}x{height}x{spp}spp depth={max_depth}: {dt * 1e3:.3f} ms/iter "
        f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f} over {iters}), "
        f"{rays_per_sec / 1e6:.1f} Mrays/s fwd+bwd, loss={float(loss):.4g}{peak}",
        file=sys.stderr,
    )
    result = {
        "metric": f"rays/s fwd+bwd {width}x{height}x{spp}spp d{max_depth} ({dev.type})",
        "value": rays_per_sec,
        "unit": "rays/s",
        "device": label,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
