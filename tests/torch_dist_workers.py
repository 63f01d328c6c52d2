"""Rank bodies of the port's two-process tests (tests/test_torch_parallel.py),
a module of their own so that a spawned rank imports only torch and the
port.  Each rank joins a gloo group through a file rendezvous, writes its
result as .npy files into the test's directory and leaves the group."""

import os

import numpy as np
import torch

from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import SceneBuilder
from cpppathtracer_tpu_torch.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.types import MaterialType

SPP, DEPTH, SEED = 2, 3, 4


def scene_camera_sky():
    """The tests' scene: a diffuse and a metal sphere on a floor, 18x15
    pixels (two ranks own 8 and 7 rows)."""
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.85, 0.85, 0.85))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.2, 0.2))
    b.add_sphere((-3.0, 1.0, 2.0), 1.0, mat_type=MaterialType.METAL, kd=(0.9, 0.9, 0.5),
                 smoothness=2.0)
    cam = Camera.make(18, 15, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device="cpu")
    return b.build(device="cpu"), cam, torch.from_numpy(procedural_sky(32, 32, seed=9))


def _join(rank, world, rendezvous):
    from cpppathtracer_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(f"file://{rendezvous}", world, rank, device="cpu")
    return distributed


def render_rank(rank, world, rendezvous, out_dir):
    """Render this rank's rows over a 2-tile CPU mesh; rank 0 saves the
    gathered frame."""
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.parallel.render import render_image_sharded

    distributed = _join(rank, world, rendezvous)
    try:
        scene, cam, sky = scene_camera_sky()
        rad, _, t0 = render_image_sharded(scene, cam, sky, make_tile_mesh(["cpu"] * 2),
                                          spp=SPP, max_depth=DEPTH, seed=SEED)
        lo, hi = distributed.process_rows(cam.height)
        if rad.shape[0] != hi - lo:
            raise AssertionError(f"rank {rank} rendered {rad.shape[0]} rows, owns {hi - lo}")
        frame, depth = distributed.gather_frame(rad), distributed.gather_frame(t0)
        if rank == 0:
            np.save(os.path.join(out_dir, "frame.npy"), frame)
            np.save(os.path.join(out_dir, "depth.npy"), depth)
        elif frame is not None:
            raise AssertionError("gather_frame returned a frame on a rank other than 0")
    finally:
        distributed.shutdown()


def train_rank(rank, world, rendezvous, out_dir, compiled=False):
    """One distributed sharded train step (fields kd and emission) over a
    2-tile CPU mesh per rank; rank 0 saves the loss and the gradients.
    `compiled`: the compiled step's bookkeeping
    (``inverse.sharded_train_step_graphed``) through the test stand-in
    for the capture, which runs each graph's body."""
    from cpppathtracer_tpu_torch.inverse import (
        InverseConfig, make_sharded_train_step, sharded_train_step_graphed,
    )
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh
    from cpppathtracer_tpu_torch.utils.graphs import GraphedCall

    from torch_run_body import RunBody

    distributed = _join(rank, world, rendezvous)
    try:
        scene, cam, sky = scene_camera_sky()
        cfg = InverseConfig(spp=1, max_depth=2, fields=("kd", "emission"))
        mesh = make_tile_mesh(["cpu"] * 2)
        init, step = make_sharded_train_step(mesh, cam, cfg)
        if compiled:
            runner = GraphedCall(backend=RunBody())
            step = lambda *args: sharded_train_step_graphed(runner, mesh, cam, cfg, *args)
        params, opt, pix, tgt = init(scene, np.full((cam.height * cam.width, 3), 0.3, np.float32))
        params, opt, loss = step(params, opt, scene, sky, pix, tgt)
        if rank == 0:
            np.save(os.path.join(out_dir, "loss.npy"), loss.numpy())
            for k, v in params.items():
                np.save(os.path.join(out_dir, f"grad_{k}.npy"), v.grad.numpy())
    finally:
        distributed.shutdown()


def compiled_train_rank(rank, world, rendezvous, out_dir):
    """train_rank through the compiled step's bookkeeping."""
    train_rank(rank, world, rendezvous, out_dir, compiled=True)
