"""The port's pixel-tile mesh across real devices: one process over every
visible card, then one process per card through torch.distributed.

    python3 scripts/torch_mesh_cards.py [--size 1024] [--spp 4] [--reps 5]
    python3 scripts/torch_mesh_cards.py --device cpu --procs 4 --size 64 --spp 1 --reps 1

Part 1, one process (CUDA only): the demo scene at SIZE^2 x SPP spp x d8
over ``make_tile_mesh()`` of every visible card, against the unsharded
render on the first card: bitwise, and wall times (median of `reps` warm
runs, each ending in a synchronize of every card); then the sharded loss
and its kd / emission gradients at 256^2 x 1 spp x d4 over the same mesh
against the single-device ones (rtol 1e-5 / 1e-4, atol 1e-7); then
``inverse.make_sharded_train_step`` at that size, eager and compiled (its
CUDA graphs: a body a card and three on the first): each form's first
step (the compiled one's captures its graphs) held to the single device's
loss and gradients, the compiled loss bitwise the eager one's, and the
median ms of `reps` later steps of each.

Part 2, `procs` processes (default: one per visible card; NCCL on the
cards, gloo with --device cpu), a file rendezvous in a temporary
directory: each rank renders its ``host_tile_rows`` on its own device and
``gather_frame`` assembles the frame on rank 0, which holds it bitwise
against its own unsharded render and times both; then
``inverse.make_sharded_train_step``, eager and compiled, at min(256,
SIZE)^2 x 1 spp x d4: each form's first step's all-reduced loss and
gradients, which rank 0 holds against the one-process step (rtol 1e-5 /
1e-4), the compiled loss bitwise the eager one's, and the median ms of
`reps` later steps of each form.

Prints one JSON line per part with the device's name (and, on the card,
its power limit); any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CAMERA = dict(origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0))
DEPTH = 8
LOSS_SIZE, LOSS_DEPTH = 256, 4


def _card() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return "; ".join(out) or torch.cuda.get_device_name(0)


def _scene(dev, size):
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky

    return (demo_scene(0).build(device=dev), Camera.make(size, size, device=dev, **CAMERA),
            torch.from_numpy(procedural_sky(256, 256)).to(dev))


def _sync(devices):
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _median_ms(fn, reps, devices):
    fn()  # warm-up
    times = []
    for _ in range(reps):
        _sync(devices)
        t0 = time.perf_counter()
        out = fn()
        _sync(devices)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times), times


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _grads_close(l1, g1, l2, g2):
    return bool(torch.allclose(l2.detach().to(l1.device), l1.detach(), rtol=1e-5, atol=0.0)) and all(
        bool(torch.allclose(b.to(a.device), a, rtol=1e-4, atol=1e-7)) for a, b in zip(g1, g2))


def _single_loss(scene, cam, sky, target, fields=("kd", "emission")):
    from cpppathtracer_tpu_torch.integrator import render_radiance

    full = scene.material_params()
    p = {k: full[k].detach().clone().requires_grad_(True) for k in fields}
    rad, _, _ = render_radiance(scene.with_material_params(p), cam, sky, spp=1,
                                max_depth=LOSS_DEPTH, seed=0)
    loss = torch.mean((rad - target.reshape(-1, 3)) ** 2)
    return loss, torch.autograd.grad(loss, list(p.values()))


def _train_forms(mesh, cam, scene, sky, target, reps, devices):
    """make_sharded_train_step's eager and compiled forms (kd and
    emission, 1 spp, d4) from the same start: {form: (the first step's
    loss, its gradients, its ms, the median ms of `reps` later steps)}."""
    from cpppathtracer_tpu_torch.inverse import InverseConfig, make_sharded_train_step

    cfg = InverseConfig(spp=1, max_depth=LOSS_DEPTH, fields=("kd", "emission"))
    forms = {}
    for name in ("eager", "compiled"):
        init, step = make_sharded_train_step(mesh, cam, cfg, eager=name == "eager")
        params, opt, pix, tgt = init(scene, target)
        run = lambda: step(params, opt, scene, sky, pix, tgt)
        _sync(devices)
        t0 = time.perf_counter()
        loss = run()[2]
        _sync(devices)
        first_ms = (time.perf_counter() - t0) * 1e3
        grads = [params[k].grad.clone() for k in cfg.fields]
        _, ms, _ = _median_ms(run, reps, devices)
        forms[name] = (loss, grads, first_ms, ms)
        step.graphs.clear()
    return forms


def _train_columns(forms, l1, g1):
    """The JSON columns of _train_forms against the single device's loss
    l1 and gradients g1."""
    (le, ge, _, ms_e), (lc, gc, first_c, ms_c) = forms["eager"], forms["compiled"]
    return dict(train_step_ms=ms_e, train_step_compiled_ms=ms_c, train_first_compiled_ms=first_c,
                train_close=_grads_close(l1, g1, le, ge) and _grads_close(l1, g1, lc, gc),
                train_loss_bitwise=bool(torch.equal(lc, le)))


def one_process(args):
    """Part 1: every visible card under one process."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.parallel.render import (
        global_pixel_grid, make_sharded_loss, render_image_sharded,
    )

    mesh = make_tile_mesh()
    dev = mesh.first_device
    devices = mesh.distinct_devices()
    scene, cam, sky = _scene(dev, args.size)
    with torch.no_grad():
        (rad, n0, t0), ms_one, _ = _median_ms(
            lambda: render_radiance(scene, cam, sky, spp=args.spp, max_depth=DEPTH, seed=0),
            args.reps, [dev])
    s = args.size
    whole = (rad.reshape(s, s, 3), n0.reshape(s, s, 3), t0.reshape(s, s))
    tiled, ms_mesh, runs = _median_ms(
        lambda: render_image_sharded(scene, cam, sky, mesh, spp=args.spp, max_depth=DEPTH, seed=0),
        args.reps, devices)
    same = all(torch.equal(a, b) for a, b in zip(tiled, whole))

    small = cam.resize(LOSS_SIZE, LOSS_SIZE)
    target = torch.full((LOSS_SIZE, LOSS_SIZE, 3), 0.25, device=dev)
    l1, g1 = _single_loss(scene, small, sky, target)
    full = scene.material_params()
    p2 = {k: full[k].detach().clone().requires_grad_(True) for k in ("kd", "emission")}
    l2 = make_sharded_loss(mesh, 1, LOSS_DEPTH, 0)(p2, scene, small, sky,
                                                   global_pixel_grid(small, mesh), target)
    g2 = torch.autograd.grad(l2, list(p2.values()))
    close = _grads_close(l1, g1, l2, g2)
    train = _train_columns(_train_forms(mesh, small, scene, sky, target, args.reps, devices),
                           l1, g1)
    out = dict(part="one process", mesh=list(mesh.shape), devices=[str(d) for d in devices],
               size=s, spp=args.spp, depth=DEPTH, unsharded_ms=ms_one, mesh_ms=ms_mesh,
               mesh_runs_ms=runs, bitwise=same, loss_grads_close=close, **train)
    print(json.dumps(out), flush=True)
    _check(same, "the tiled render over the cards differs from the unsharded render")
    _check(close, "the sharded loss or its gradients differ from the single-device ones")
    _check(train["train_close"] and train["train_loss_bitwise"],
           "the sharded train step's loss or gradients differ, compiled or eager")


def rank_main(rank, world, args, rendezvous, out_dir):
    """Part 2: one rank, on its own device."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.parallel import distributed
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.parallel.render import render_image_sharded

    if args.device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    distributed.initialize(f"file://{rendezvous}", world, rank, device=dev)
    try:
        mesh = make_tile_mesh([dev])
        scene, cam, sky = _scene(dev, args.size)
        barrier = torch.distributed.barrier

        def band():
            out = render_image_sharded(scene, cam, sky, mesh, spp=args.spp, max_depth=DEPTH, seed=0)
            _sync([dev])
            barrier()
            return out

        barrier()
        (rad, _, _), ms_band, _ = _median_ms(band, args.reps, [dev])
        frame = distributed.gather_frame(rad)

        side = min(LOSS_SIZE, args.size)
        small = cam.resize(side, side)
        target = torch.full((side * side, 3), 0.25)
        forms = _train_forms(mesh, small, scene, sky, target, args.reps, [dev])
        if rank == 0:
            with torch.no_grad():
                (whole, _, _), ms_one, _ = _median_ms(
                    lambda: render_radiance(scene, cam, sky, spp=args.spp, max_depth=DEPTH, seed=0),
                    args.reps, [dev])
            s = args.size
            same = bool(np.array_equal(frame, whole.reshape(s, s, 3).cpu().numpy()))
            l1, g1 = _single_loss(scene, small, sky, target.to(dev))
            Path(out_dir, "rank0.json").write_text(json.dumps(dict(
                part=f"{world} processes", backend=torch.distributed.get_backend(), size=s,
                spp=args.spp, depth=DEPTH, band_ms=ms_band, unsharded_ms=ms_one, bitwise=same,
                **_train_columns(forms, l1, g1))))
    finally:
        distributed.shutdown()


def many_processes(args):
    world = args.procs or torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(world, args, os.path.join(tmp, "rendezvous"), tmp),
                           nprocs=world, start_method="spawn")
        out = json.loads(Path(tmp, "rank0.json").read_text())
    print(json.dumps(out), flush=True)
    _check(out["bitwise"], "the gathered frame differs from the unsharded render")
    _check(out["train_close"] and out["train_loss_bitwise"],
           "the distributed step's loss or gradients differ, compiled or eager")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--procs", type=int, default=None)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for the gloo part alone")
    print(f"[mesh] {_card()}; torch {torch.__version__}", flush=True)
    if args.device == "cuda":
        one_process(args)
    many_processes(args)


if __name__ == "__main__":
    main()
