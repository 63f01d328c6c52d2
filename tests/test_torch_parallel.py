"""The port's pixel-tile mesh, multi-process helpers and entry points on the
CPU: twins of tests/test_sharding.py, tests/test_distributed.py,
tests/test_inverse.py::test_sharded_train_step_matches_single and
tests/test_entry.py on an 8-entry CPU mesh (one device standing in for
eight, as the JAX tests' eight virtual CPU devices do), and two gloo
processes through a file rendezvous."""

import dataclasses
import multiprocessing.connection
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cpppathtracer_tpu.parallel.distributed import host_tile_rows as j_host_tile_rows
from cpppathtracer_tpu_torch.entry import dryrun_multichip, entry
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.inverse import InverseConfig, make_sharded_train_step
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.models.scene import SceneBuilder
from cpppathtracer_tpu_torch.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.parallel.distributed import (
    gather_frame,
    host_tile_rows,
    render_with_recovery,
)
from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh, pad_to_tiles
from cpppathtracer_tpu_torch.parallel.render import make_sharded_loss, render_image_sharded
from cpppathtracer_tpu_torch.types import MaterialType

import torch_dist_workers as workers

torch.set_num_threads(1)

CPU = "cpu"
SKY = torch.from_numpy(procedural_sky(32, 32, seed=9))


def _scene():
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.85, 0.85, 0.85))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.2, 0.2))
    b.add_sphere((-3.0, 1.0, 2.0), 1.0, mat_type=MaterialType.METAL, kd=(0.9, 0.9, 0.5),
                 smoothness=2.0)
    return b.build(device=CPU)


@pytest.fixture(scope="module")
def mesh():
    return make_tile_mesh([CPU] * 8)


# ---- twins of tests/test_sharding.py


def test_mesh_shape(mesh):
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("ty", "tx")


def test_pad_to_tiles(mesh):
    assert pad_to_tiles(10, 10, mesh) == (10, 12)
    assert pad_to_tiles(8, 8, mesh) == (8, 8)


def test_sharded_equals_single_device(mesh):
    scene = _scene()
    cam = Camera.make(20, 14, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device=CPU)
    rad_s, n_s, t_s = render_image_sharded(scene, cam, SKY, mesh, spp=2, max_depth=3, seed=4)
    rad_1, n_1, t_1 = render_radiance(scene, cam, SKY, spp=2, max_depth=3, seed=4)
    h, w = cam.height, cam.width
    np.testing.assert_array_equal(rad_s.numpy(), rad_1.reshape(h, w, 3).numpy())
    np.testing.assert_array_equal(n_s.numpy(), n_1.reshape(h, w, 3).numpy())
    np.testing.assert_array_equal(t_s.numpy(), t_1.reshape(h, w).numpy())


def test_sharded_output_is_sharded(mesh):
    cam = Camera.make(16, 16, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device=CPU)
    rad, _, _ = render_image_sharded(_scene(), cam, SKY, mesh, spp=1, max_depth=2, seed=0)
    assert rad.shape == (16, 16, 3)
    assert torch.isfinite(rad).all()


@pytest.mark.parametrize("shape", [(3, 1), (1, 5), (3, 2)])
def test_sharded_equals_single_device_on_padded_meshes(shape):
    """Meshes that pad both image axes (13x11 over 3, 5 or 3x2 tiles): the
    crop leaves the unsharded frame bitwise."""
    mesh = make_tile_mesh([CPU] * (shape[0] * shape[1]), shape)
    scene = _scene()
    cam = Camera.make(13, 11, origin=(1.0, 5.0, -12.0), look_at=(0.0, 2.0, 0.0), device=CPU)
    rad_s, _, t_s = render_image_sharded(scene, cam, SKY, mesh, spp=1, max_depth=2, seed=7)
    rad_1, _, t_1 = render_radiance(scene, cam, SKY, spp=1, max_depth=2, seed=7)
    assert torch.equal(rad_s, rad_1.reshape(11, 13, 3)) and torch.equal(t_s, t_1.reshape(11, 13))


def test_tiles_with_another_split_plan_differ_only_in_sum_order():
    """The limit of the bitwise claim, shared with the JAX package: a
    sample whose ray count takes another survivor-split plan than the
    frame's (ops/mega.py::_split_plan; 64^2 rays split at depth 4, a
    32x16 tile does not) adds the same path radiance in another float32
    order.  First hits stay bitwise; radiance agrees to float32 rounding."""
    from cpppathtracer_tpu_torch.ops.mega import _split_plan

    mesh = make_tile_mesh([CPU] * 8)
    assert _split_plan(64 * 64, 4) and not _split_plan(32 * 16, 4)
    b = SceneBuilder()  # emitters: radiance gathers at bounces on both sides of the split
    b.add_platform(0.0, kd=(0.85, 0.85, 0.85))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.2, 0.2), emission=0.7)
    b.add_sphere((-3.0, 1.0, 2.0), 1.0, mat_type=MaterialType.METAL, kd=(0.9, 0.9, 0.5),
                 smoothness=2.0, emission=1.3)
    b.add_sphere((3.0, 1.0, 2.0), 1.0, kd=(0.9, 0.9, 0.5), emission=2.0)
    scene = b.build(device=CPU)
    cam = Camera.make(64, 64, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device=CPU)
    rad_s, n_s, t_s = render_image_sharded(scene, cam, SKY, mesh, spp=1, max_depth=4, seed=2)
    rad_1, n_1, t_1 = render_radiance(scene, cam, SKY, spp=1, max_depth=4, seed=2)
    assert torch.equal(n_s, n_1.reshape(64, 64, 3)) and torch.equal(t_s, t_1.reshape(64, 64))
    torch.testing.assert_close(rad_s, rad_1.reshape(64, 64, 3), rtol=1e-6, atol=1e-7)


def test_make_tile_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_tile_mesh()


# ---- twins of tests/test_distributed.py


def test_host_tile_rows_cover_and_disjoint():
    for h, n in [(720, 4), (100, 8), (7, 3), (8, 8), (5, 8)]:
        rows = [host_tile_rows(h, n, i) for i in range(n)]
        covered = []
        for lo, hi in rows:
            assert 0 <= lo <= hi <= h
            covered.extend(range(lo, hi))
        assert covered == list(range(h))


def test_host_tile_rows_equal_jax():
    for h in range(1, 41):
        for n in range(1, 6):
            for i in range(n):
                assert host_tile_rows(h, n, i) == j_host_tile_rows(h, n, i), (h, n, i)


def test_process_rows_refuses_a_rank_without_rows(monkeypatch):
    from cpppathtracer_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "world", lambda: (8, 7))
    assert distributed.process_rows(720) == (630, 720)
    with pytest.raises(ValueError, match="no row"):
        distributed.process_rows(5)


def test_gather_frame_single_process():
    img = torch.arange(24.0).reshape(2, 4, 3)
    np.testing.assert_array_equal(gather_frame(img), img.numpy())


def test_render_with_recovery_checkpoints_and_resumes(tmp_path):
    path = str(tmp_path / "state.npz")
    calls = {"n": 0}

    def step(state, i):
        calls["n"] += 1
        # inject one failure at step 5 after a checkpoint at step 4
        if i == 5 and calls["n"] == 6:
            raise RuntimeError("injected")
        return {"acc": state["acc"] + 1.0}

    gen = render_with_recovery(step, {"acc": torch.zeros(())}, checkpoint_path=path,
                               checkpoint_every=2, max_retries=2)
    out = None
    for i, st in gen:
        out = st
        if i >= 8:
            break
    # 8 successful increments despite the injected failure
    assert float(out["acc"]) == 8.0


def test_render_with_recovery_gives_up(tmp_path):
    def step(state, i):
        raise RuntimeError("always")

    gen = render_with_recovery(step, {"acc": torch.zeros(())},
                               checkpoint_path=str(tmp_path / "s.npz"), max_retries=1)
    with pytest.raises(RuntimeError, match="always"):
        next(gen)


def test_render_with_recovery_restores_initial_state_before_first_ckpt(tmp_path):
    """A failure BEFORE the first checkpoint retries from the ENTRY state.
    Here the step changes its state in place, as torch code may, before it
    fails: a retry from the entry tensors themselves would start at 2."""
    calls = {"n": 0}

    def step(state, i):
        calls["n"] += 1
        state["acc"].add_(1.0)
        if calls["n"] == 2:  # fail on the second call (i=1, no ckpt yet)
            raise RuntimeError("injected-early")
        return state

    entry_state = {"acc": torch.zeros(())}
    gen = render_with_recovery(step, entry_state, checkpoint_path=str(tmp_path / "none.npz"),
                               checkpoint_every=100, max_retries=2)
    out = None
    for i, st in gen:
        out = st
        if i >= 3:
            break
    # i restarts from 0 after the failure; each success adds exactly 1
    assert float(out["acc"]) == 3.0


# ---- twin of tests/test_inverse.py::test_sharded_train_step_matches_single


def _inverse_setup():
    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.3, 0.2))
    cam = Camera.make(16, 12, origin=(0.0, 4.0, -11.0), look_at=(0.0, 2.0, 0.0),
                      view_fov=40.0, lens_radius=0.0, device=CPU)
    return b.build(device=CPU), cam


def test_sharded_train_step_matches_single(mesh):
    scene, cam = _inverse_setup()
    sky = torch.from_numpy(procedural_sky(32, 32, seed=4))
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd",), learning_rate=0.05)
    target = torch.zeros((cam.height * cam.width, 3))

    kd1 = scene.kd.clone().requires_grad_()
    rad, _, _ = render_radiance(dataclasses.replace(scene, kd=kd1), cam, sky, spp=1, max_depth=2,
                                seed=0)
    l1 = torch.mean((rad - target) ** 2)
    (g1,) = torch.autograd.grad(l1, kd1)

    init, step = make_sharded_train_step(mesh, cam, cfg)
    params, opt, pix, tgt = init(scene, target)
    kd2 = scene.kd.clone().requires_grad_()
    l2 = make_sharded_loss(mesh, 1, 2, 0)({"kd": kd2}, scene, cam, sky, pix, tgt)
    (g2,) = torch.autograd.grad(l2, kd2)
    np.testing.assert_allclose(float(l2.detach()), float(l1.detach()), rtol=1e-5)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-4, atol=1e-7)

    # one full optimizer step runs and is finite
    params2, opt, loss = step(params, opt, scene, sky, pix, tgt)
    assert np.isfinite(float(loss))
    assert torch.isfinite(params2["kd"]).all()
    np.testing.assert_allclose(params2["kd"].grad.numpy(), g1.numpy(), rtol=1e-4, atol=1e-7)


# ---- twins of tests/test_entry.py


def test_entry_compiles_and_runs():
    fn, args = entry(device=CPU)
    out = fn(*args)
    assert out.shape == (128 * 128, 3)
    assert torch.isfinite(out).all()


def test_dryrun_multichip():
    assert np.isfinite(dryrun_multichip(8, devices=[CPU] * 8))


# ---- two processes, gloo


def _run_ranks(target, tmp_path, world=2, timeout=120.0):
    """Start `world` spawned ranks of target(rank, world, rendezvous,
    out_dir); fail as soon as one exits non-zero, or after `timeout`
    seconds, killing the others."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, str(tmp_path / "rendezvous"),
                                              str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            multiprocessing.connection.wait([p.sentinel for p in procs if p.is_alive()],
                                            timeout=max(0.0, deadline - time.monotonic()))
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
        for p in procs:
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert not hung and codes == [0] * world, f"rank exit codes {codes}"


def test_two_ranks_gather_frame_equals_one_process(tmp_path):
    """Each rank renders its host_tile_rows (8 and 7 of 15) over a 2-tile
    mesh; gather_frame on rank 0 equals the one-process render bitwise."""
    _run_ranks(workers.render_rank, tmp_path)
    scene, cam, sky = workers.scene_camera_sky()
    rad, _, t0 = render_radiance(scene, cam, sky, spp=workers.SPP, max_depth=workers.DEPTH,
                                 seed=workers.SEED)
    h, w = cam.height, cam.width
    np.testing.assert_array_equal(np.load(tmp_path / "frame.npy"), rad.reshape(h, w, 3).numpy())
    np.testing.assert_array_equal(np.load(tmp_path / "depth.npy"), t0.reshape(h, w).numpy())


def test_two_ranks_train_step_matches_one_process(tmp_path):
    """The distributed sharded train step: the all-reduced loss and
    gradients equal the one-process step's within rtol 1e-5 / 1e-4."""
    _run_ranks(workers.train_rank, tmp_path)
    _matches_one_process_step(tmp_path)


def test_two_ranks_compiled_train_step_matches_one_process(tmp_path):
    """The compiled sharded train step's bookkeeping in two ranks (each
    graph's body run by the test stand-in for the capture; n, the loss and
    the gradients all-reduced between the replays): the loss and gradients
    equal the one-process step's within rtol 1e-5 / 1e-4."""
    _run_ranks(workers.compiled_train_rank, tmp_path)
    _matches_one_process_step(tmp_path)


def _matches_one_process_step(tmp_path):
    """The loss and gradients rank 0 saved against the one-process step's
    over a 4-tile mesh, within rtol 1e-5 / 1e-4."""
    scene, cam, sky = workers.scene_camera_sky()
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd", "emission"))
    init, step = make_sharded_train_step(make_tile_mesh([CPU] * 4), cam, cfg)
    params, opt, pix, tgt = init(scene, np.full((cam.height * cam.width, 3), 0.3, np.float32))
    params, opt, loss = step(params, opt, scene, sky, pix, tgt)
    np.testing.assert_allclose(np.load(tmp_path / "loss.npy"), loss.numpy(), rtol=1e-5)
    for k in cfg.fields:
        np.testing.assert_allclose(np.load(tmp_path / f"grad_{k}.npy"), params[k].grad.numpy(),
                                   rtol=1e-4, atol=1e-7)
