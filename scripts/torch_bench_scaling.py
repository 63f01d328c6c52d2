"""Weak scaling of the PyTorch/CUDA port's sharded fwd+bwd step over devices
(the card's twin of scripts/bench_scaling.py, whose flags and defaults it
keeps).

Times the program of bench_scaling.py:93-118: ``demo_scene(0)`` with
``procedural_sky(64, 64, seed=1)``, the loss of
``parallel.render.make_sharded_loss(mesh, spp, depth)`` against a zero
image, and its value and kd / emission gradients by
``torch.autograd.grad`` (no optimiser, as JAX's ``value_and_grad``).
Each device keeps one tile of TILE x TILE pixels (weak scaling), so ideal
scaling is a flat step time and efficiency_n = t_1 / t_n within a mode.
The card has two forms of the mesh, and --mode picks either or both:

  process  one process over ``make_tile_mesh(visible_cards()[:n])``, the
           image tile*ty x tile*tx.  The collective is autograd's
           cross-device ``.to()`` of each tile's gradients onto the first
           card (the counterpart of the psum, parallel/render.py:126-140);
           ``comm_step_s`` times that copy and sum alone over a gradient
           tree of the step's shapes, ``dispatch_s`` ``x + 1`` on an
           8x128 tensor on every card and a synchronize of all.
  procs    n processes, one card each (NCCL; gloo on the CPU), a file
           rendezvous in a temporary directory; the image tile*n rows x
           tile columns, each rank rendering its ``process_rows`` band on
           ``make_tile_mesh([its card])``.  The step is the loss share, its
           gradients and ``dist.all_reduce`` of the loss and of each
           gradient (``inverse.make_sharded_train_step`` without the Adam
           update), behind a ``dist.barrier()``; its time is the slowest
           rank's.  ``comm_step_s`` times the gradients' all-reduce alone,
           ``dispatch_s`` ``x + 1`` and a synchronize on each rank.  Every
           rank has a hard timeout (--rank-timeout), past which it prints
           its threads' stacks and exits, so a hung rank fails the run and
           shows where it hung.

Each mode times the step twice over: eagerly (``step_s``, the loss and
``torch.autograd.grad``, PR 12's figures) and compiled (the ``compiled``
columns: ``parallel.render.make_sharded_value_and_grad``, the counterpart
of bench_scaling.py:113's ``jax.jit(jax.value_and_grad(loss_fn))``, whose
graphs one device body a card, plus a count and a reduce on the first,
replay a capture made by its first call; ``first_s`` is that first call).
On the CPU the compiled call is the eager step, as every compiled entry
point of the port is there.

Each step time is the best of 3 after a warm-up (bench_scaling.py:69-78),
``comm_step_s`` and ``dispatch_s`` the best of 10; on the card ``busy_ms``
is the first card's (rank 0's) device busy ms over one step under
torch.profiler and ``peak_gib`` its peak allocated memory over the warm-up
and timed steps.  Outside the timed window every row's loss and gradients
are held against a one-process, one-card step on the same image (rtol
1e-5 for the loss, 1e-4 / atol 1e-7 for the gradients, the tolerances of
scripts/torch_mesh_cards.py); a row that misses fails the run.

JAX's CPU-only corrections are left out (the ``taskset`` single-core
probe, ``host_cores``, ``efficiency_core_adjusted_simulation_bound``,
``efficiency_vs_pinned_core``, bench_scaling.py:171-213): they correct
for virtual CPU devices that share the host's cores, and a card is a real
device.  What one host issuing every device's work costs shows instead in
the ``process`` rows beside the ``procs`` rows.  No efficiency target is
stated: the JAX docstring's ">=90%" is a goal set for TPU hosts over ICI.

Runs on the CUDA cards unless --device says otherwise (on the CPU the
``process`` mesh is n "cpu" entries, as the CPU tests use, and ``procs``
uses gloo); without a card and without --device it raises.  Writes its
JSON to --out, never to the JAX harness's SCALING_r4.json or
SCALING_r5.json (CPU and TPU measurements), prints one summary line on
stdout and its progress on stderr.

Usage: python scripts/torch_bench_scaling.py [--tile 256] [--spp 2] [--depth 4]
           [--counts 1,2,4] [--mode process|procs|both] [--rank-timeout 900]
           [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import multiprocessing.connection
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from cpppathtracer_tpu_torch.bench import busy_ms, device_label, profile_busy_ms  # noqa: E402
from cpppathtracer_tpu_torch.integrator import render_radiance  # noqa: E402
from cpppathtracer_tpu_torch.models.camera import Camera  # noqa: E402
from cpppathtracer_tpu_torch.models.scene import demo_scene  # noqa: E402
from cpppathtracer_tpu_torch.ops.texture import procedural_sky  # noqa: E402
from cpppathtracer_tpu_torch.parallel import distributed  # noqa: E402
from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh, visible_cards  # noqa: E402
from cpppathtracer_tpu_torch.parallel.render import (  # noqa: E402
    global_pixel_grid,
    make_sharded_loss,
    make_sharded_value_and_grad,
)
from cpppathtracer_tpu_torch.types import resolve_device  # noqa: E402

JAX_FILES = ("SCALING_r4.json", "SCALING_r5.json")
CAMERA = dict(origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
FIELDS = ("kd", "emission")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def scene_and_sky(dev):
    return demo_scene(0).build(device=dev), torch.from_numpy(procedural_sky(64, 64, seed=1)).to(dev)


def leaf_params(scene):
    full = scene.material_params()
    return {k: full[k].detach().clone().requires_grad_(True) for k in FIELDS}


def sync_all(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def timed(fn, iters, before=lambda: None, reduce=lambda t: t):
    """Best time of `iters` calls of fn() (each waits for its own work),
    each after before(); reduce(t) turns a call's time into the one kept
    (across ranks: the slowest).  Returns (seconds, fn()'s last result)."""
    best, out = math.inf, None
    for _ in range(iters):
        before()
        t0 = time.perf_counter()
        out = fn()
        best = min(best, reduce(time.perf_counter() - t0))
    return best, out


def one_card_step(dev, cam, args):
    """The reference: the same image's loss (the mean squared radiance
    against the zero target) and gradients, one process on one device."""
    scene, sky = scene_and_sky(dev)
    params = leaf_params(scene)
    rad, _, _ = render_radiance(scene.with_material_params(params), cam, sky, spp=args.spp,
                                max_depth=args.depth, seed=0)
    loss = torch.mean(rad * rad)
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


def compare(ref, got):
    """The check of a row: loss within rtol 1e-5, gradients within rtol
    1e-4 / atol 1e-7 of the one-card step's, and the gaps measured."""
    (l1, g1), (l2, g2) = ref, got
    l2, g2 = l2.to(l1.device), [g.to(l1.device) for g in g2]
    ok = bool(torch.allclose(l2, l1, rtol=1e-5, atol=0.0)) and all(
        bool(torch.allclose(b, a, rtol=1e-4, atol=1e-7)) for a, b in zip(g1, g2))
    return {"ok": ok, "loss_rel": float((l2 - l1).abs() / l1.abs()),
            "grad_max_abs": {k: float((b - a).abs().max()) for k, a, b in zip(FIELDS, g1, g2)}}


def peak_gib(dev):
    """The device's peak allocated memory since the last reset, in GiB (None on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def row(n, mode, mesh, h, w, args, t_step, loss, grads, t_comm, t_disp, busy, check, peak,
        compiled):
    return {
        "n_devices": n, "mode": mode, "mesh": list(mesh), "image": [h, w],
        "step_s": t_step, "rays_per_s": h * w * args.spp * args.depth / t_step,
        "loss": float(loss), "comm_bytes": sum(g.numel() * g.element_size() for g in grads),
        "comm_step_s": t_comm, "dispatch_s": t_disp, "compute_s_est": t_step - t_comm,
        "busy_ms": busy, "peak_gib": peak, "check": check,
        "compiled": dict(compiled, rays_per_s=h * w * args.spp * args.depth / compiled["step_s"]),
    }


def compiled_columns(t_first, t_step, out, busy, ref, eager_loss):
    """The compiled step's columns: its first call's seconds (the capture),
    best step seconds, busy ms, check against the one-card step, and
    whether its loss is the eager step's bit for bit."""
    return {"first_s": t_first, "step_s": t_step, "busy_ms": busy, "check": compare(ref, out),
            "loss_bitwise": bool(torch.equal(out[0], eager_loss))}


def process_row(n, args, dev):
    """One process over a mesh of n devices: n cards, or n "cpu" entries."""
    mesh = make_tile_mesh(visible_cards()[:n] if dev.type == "cuda" else ["cpu"] * n)
    first, cards = mesh.first_device, mesh.distinct_devices()
    ty, tx = mesh.shape
    h, w = args.tile * ty, args.tile * tx
    scene, sky = scene_and_sky(first)
    cam = Camera.make(w, h, device=first, **CAMERA)
    pix = global_pixel_grid(cam, mesh)
    target = torch.zeros(pix.shape + (3,), device=first)
    loss_fn = make_sharded_loss(mesh, args.spp, args.depth)
    params = leaf_params(scene)

    def step():
        loss = loss_fn(params, scene, cam, sky, pix, target)
        grads = torch.autograd.grad(loss, list(params.values()))
        sync_all(cards)
        return loss.detach(), grads

    if first.type == "cuda":
        torch.cuda.reset_peak_memory_stats(first)
    step()  # warm-up
    t_step, (loss, grads) = timed(step, 3)
    peak = peak_gib(first)
    vg = make_sharded_value_and_grad(mesh, args.spp, args.depth)

    def step_compiled():
        loss_c, grads_c = vg(params, scene, cam, sky, pix, target)
        sync_all(cards)
        return loss_c, list(grads_c.values())

    t_first, _ = timed(step_compiled, 1)  # the capture and one replay
    t_compiled, out_c = timed(step_compiled, 3)
    # autograd's collective: each card's gradient tree copied to the first card and summed
    trees = [[g.to(d) for g in grads] for d in cards]

    def comm():
        out = [sum(t[i].to(first) for t in trees) for i in range(len(grads))]
        sync_all(cards)
        return out

    comm()
    t_comm, _ = timed(comm, 10)
    tiny = {d: torch.zeros(8, 128, device=d) for d in cards}

    def near_empty():
        for _, _, d in mesh.tiles():
            tiny[d] + 1.0
        sync_all(cards)

    near_empty()
    t_disp, _ = timed(near_empty, 10)
    on_card = first.type == "cuda"
    busy = busy_ms(step, first) if on_card else None
    busy_c = busy_ms(step_compiled, first) if on_card else None
    vg.graphs.clear()
    ref = one_card_step(first, cam, args)
    return row(n, "process", (ty, tx), h, w, args, t_step, loss, grads, t_comm, t_disp, busy,
               compare(ref, (loss, grads)), peak,
               compiled_columns(t_first, t_compiled, out_c, busy_c, ref, loss))


def rank_main(rank, world, args, on_card, rendezvous, out_dir, spawned):
    """One rank of the procs mode, on its own device, with a line on
    stderr when it is up (seconds after its spawn at time `spawned`) and
    when it is done.  A rank still running after --rank-timeout seconds
    prints every thread's stack to stderr and exits non-zero."""
    faulthandler.dump_traceback_later(args.rank_timeout, exit=True)
    log(f"[scaling] rank {rank}/{world} up {time.time() - spawned:.1f} s after its spawn")
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    distributed.initialize(f"file://{rendezvous}", world, rank, device=dev)
    try:
        mesh = make_tile_mesh([dev])
        scene, sky = scene_and_sky(dev)
        cam = Camera.make(args.tile, args.tile * world, device=dev, **CAMERA)
        pix = global_pixel_grid(cam, mesh, distributed.process_rows(cam.height))
        target = torch.zeros(pix.shape + (3,), device=dev)
        loss_fn = make_sharded_loss(mesh, args.spp, args.depth)
        params = leaf_params(scene)

        def step():
            loss = loss_fn(params, scene, cam, sky, pix, target)
            grads = torch.autograd.grad(loss, list(params.values()))
            loss = loss.detach()
            dist.all_reduce(loss)
            for g in grads:
                dist.all_reduce(g)
            sync()
            return loss, grads

        def barrier():
            sync()
            dist.barrier()

        def slowest(t):
            t = torch.tensor([t], dtype=torch.float64, device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return float(t)

        vg = make_sharded_value_and_grad(mesh, args.spp, args.depth)

        def step_compiled():
            loss_c, grads_c = vg(params, scene, cam, sky, pix, target)
            dist.all_reduce(loss_c)
            for g in grads_c.values():
                dist.all_reduce(g)
            sync()
            return loss_c, list(grads_c.values())

        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        step()  # warm-up: NCCL's first all-reduce and, on a fresh tree, the kernels' build
        t_step, (loss, grads) = timed(step, 3, barrier, slowest)
        peak = peak_gib(dev)
        t_first, _ = timed(step_compiled, 1, barrier, slowest)  # the capture and one replay
        t_compiled, out_c = timed(step_compiled, 3, barrier, slowest)
        spare = [g.clone() for g in grads]

        def comm():
            for g in spare:
                dist.all_reduce(g)
            sync()

        comm()
        t_comm, _ = timed(comm, 10, barrier, slowest)
        tiny = torch.zeros(8, 128, device=dev)

        def near_empty():
            tiny + 1.0
            sync()

        t_disp, _ = timed(near_empty, 10, barrier, slowest)
        def rank_busy(fn):
            """Every rank profiles fn, and all take it again if one saw
            nothing."""
            for _ in range(3):
                mine = profile_busy_ms(fn, dev)
                least = torch.tensor([mine], dtype=torch.float64, device=dev)
                dist.all_reduce(least, op=dist.ReduceOp.MIN)
                if float(least) > 0:
                    return mine
            raise RuntimeError("torch.profiler recorded no device time")

        busy, busy_c = (rank_busy(step), rank_busy(step_compiled)) if on_card else (None, None)
        vg.graphs.clear()
        if rank == 0:
            ref = one_card_step(dev, cam, args)
            out = row(world, "procs", (world, 1), cam.height, cam.width, args, t_step, loss,
                      grads, t_comm, t_disp, busy, compare(ref, (loss, grads)), peak,
                      compiled_columns(t_first, t_compiled, out_c, busy_c, ref, loss))
            out["backend"] = dist.get_backend()
            Path(out_dir, "rank0.json").write_text(json.dumps(out))
    finally:
        distributed.shutdown()
    log(f"[scaling] rank {rank}/{world} done in {time.perf_counter() - t0:.1f} s")


def procs_row(n, args, on_card):
    """Start n spawned ranks; fail as soon as one exits non-zero, or when
    one is still alive 30 s past --rank-timeout (its own limit), killing
    the others."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="poca_scaling_") as tmp:
        spawned = time.time()
        procs = [ctx.Process(target=rank_main,
                             args=(r, n, args, on_card, os.path.join(tmp, "rendezvous"), tmp,
                                   spawned))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + args.rank_timeout + 30
        try:
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                # at most a second between looks: the sentinel of a rank that had exited
                # stayed unready until the deadline in 3 of 12 runs on the H100
                multiprocessing.connection.wait([p.sentinel for p in procs if p.is_alive()],
                                                timeout=min(1.0, deadline - time.monotonic()))
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
            for p in hung:
                p.join(10)
        log(f"[scaling] procs n={n}: ranks joined {time.time() - spawned:.1f} s after their spawn")
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * n:
            raise SystemExit(f"procs mode, n = {n}: rank exit codes {codes}"
                             + (f", {len(hung)} killed after {args.rank_timeout + 30:.0f} s"
                                if hung else ""))
        return json.loads(Path(tmp, "rank0.json").read_text())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=256, help="pixels per device side")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--counts", default=None,
                    help="device counts, e.g. 1,2,4 (default: those of 1, 2, 4, 8 the run has: "
                         "the visible cards, or on the CPU the host's cores)")
    ap.add_argument("--mode", choices=("process", "procs", "both"), default="both")
    ap.add_argument("--rank-timeout", type=float, default=900.0,
                    help="seconds after which a procs rank prints its stacks and fails the run")
    ap.add_argument("--device", default=None,
                    help="torch device type (default: the CUDA cards; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "torch_scaling.json"))
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) in {os.path.join(REPO, f) for f in JAX_FILES}:
        raise SystemExit(f"{os.path.basename(args.out)} is the JAX harness's measurement; "
                         "pass another --out")

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    available = torch.cuda.device_count() if on_card else (os.cpu_count() or 1)
    counts = ([int(x) for x in args.counts.split(",")] if args.counts
              else [n for n in (1, 2, 4, 8) if n <= available])
    if on_card and max(counts) > available:
        raise SystemExit(f"--counts {counts} asks for more than the {available} visible cards")
    modes = ("process", "procs") if args.mode == "both" else (args.mode,)
    label = device_label(dev)
    log(f"[scaling] {label}; {available} devices, counts {counts}, modes {modes}")

    rows = []
    for mode in modes:
        for n in counts:
            r = process_row(n, args, dev) if mode == "process" else procs_row(n, args, on_card)
            if on_card:
                torch.cuda.empty_cache()  # leave the cards to the next row's processes
            rows.append(r)
            log(f"[scaling] {mode} n={n} mesh={r['mesh']} image={r['image'][0]}x{r['image'][1]} "
                f"step={r['step_s'] * 1e3:.2f} ms rays/s={r['rays_per_s']:.4g} "
                f"comm={r['comm_bytes']}B comm_step={r['comm_step_s'] * 1e3:.4f} ms "
                f"dispatch={r['dispatch_s'] * 1e3:.4f} ms busy={r['busy_ms']} ms "
                f"check={r['check']}; compiled step={r['compiled']['step_s'] * 1e3:.2f} ms "
                f"first={r['compiled']['first_s'] * 1e3:.1f} ms busy={r['compiled']['busy_ms']} ms "
                f"loss bitwise the eager {r['compiled']['loss_bitwise']} "
                f"check={r['compiled']['check']}")
    for r in rows:
        one = next((q for q in rows if q["mode"] == r["mode"] and q["n_devices"] == 1), None)
        r["efficiency"] = one["step_s"] / r["step_s"] if one else None
        r["compiled"]["efficiency"] = (one["compiled"]["step_s"] / r["compiled"]["step_s"]
                                       if one else None)

    result = {
        "backend": dev.type,
        "device": label,
        "n_devices_available": available,
        "config": {"tile": args.tile, "spp": args.spp, "depth": args.depth},
        "mode": "weak-scaling (constant per-device tile)",
        "rows": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    failed = [(r["mode"], r["n_devices"], form) for r in rows
              for form, check in (("eager", r["check"]), ("compiled", r["compiled"]["check"]))
              if not check["ok"]]
    if failed:
        raise SystemExit(f"the sharded loss or gradients differ from the one-card step: {failed}")
    eff = lambda x: None if x is None else round(x, 3)
    print(json.dumps({"scaling": [{"n": r["n_devices"], "mode": r["mode"],
                                   "eff": eff(r["efficiency"]),
                                   "eff_compiled": eff(r["compiled"]["efficiency"])}
                                  for r in rows],
                      "device": label}), flush=True)


if __name__ == "__main__":
    main()
