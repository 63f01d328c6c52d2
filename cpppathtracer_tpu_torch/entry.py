"""Driver entry points (counterpart of the repository's
``__graft_entry__.py``): the demo render as a function and its arguments,
and a dry run of the sharded training step over an n-tile mesh."""

from __future__ import annotations

import math

import torch

from cpppathtracer_tpu_torch.types import resolve_device


def entry(device=None):
    """Returns (fn, example_args): the 128^2 demo render at 2 spp and
    depth 8 on `device` (default: the CUDA card); fn(*example_args) is the
    radiance f32[128 * 128, 3]."""
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.scene import demo_scene
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky

    dev = resolve_device(device)
    scene = demo_scene(seed=0).build(device=dev)
    camera = Camera.make(128, 128, origin=(130.0, 103.0, 130.0), look_at=(0.0, 0.0, 0.0),
                         device=dev)
    sky = torch.from_numpy(procedural_sky(64, 64)).to(dev)

    def fn(scene, camera, sky_tex, seed):
        with torch.no_grad():
            rad, _, _ = render_radiance(scene, camera, sky_tex, spp=2, max_depth=8, seed=seed)
        return rad

    return fn, (scene, camera, sky, 0)


def dryrun_multichip(n_devices: int, devices=None) -> float:
    """One step of the sharded training step (pixel tiles over a 2-D mesh,
    the tiles' parameter gradients summed) over an `n_devices`-tile mesh on
    a tiny three-object scene; returns the loss.  `devices` lists the
    mesh's devices (a device may repeat: ["cpu"] * 8 is an 8-tile mesh on
    the CPU); by default the first n visible CUDA cards."""
    from cpppathtracer_tpu_torch.inverse import InverseConfig, make_sharded_train_step
    from cpppathtracer_tpu_torch.models.camera import Camera
    from cpppathtracer_tpu_torch.models.scene import SceneBuilder
    from cpppathtracer_tpu_torch.ops.texture import procedural_sky
    from cpppathtracer_tpu_torch.parallel.mesh import make_tile_mesh, visible_cards
    from cpppathtracer_tpu_torch.types import MaterialType

    devices = list(visible_cards() if devices is None else devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    mesh = make_tile_mesh(devices)
    dev = mesh.first_device

    b = SceneBuilder()
    b.add_platform(0.0, kd=(0.9, 0.9, 0.9))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.3, 0.2))
    b.add_sphere((3.0, 1.0, 1.0), 1.0, mat_type=MaterialType.GLASS, ior=1.5)
    scene = b.build(device=dev)
    camera = Camera.make(16, 16, origin=(0.0, 4.0, -12.0), look_at=(0.0, 2.0, 0.0), device=dev)
    sky = torch.from_numpy(procedural_sky(16, 16)).to(dev)

    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd", "emission"))
    init, train_step = make_sharded_train_step(mesh, camera, cfg)
    target = torch.zeros((camera.height * camera.width, 3), dtype=torch.float32)
    params, opt, pix, tgt = init(scene, target)
    params, opt, loss = train_step(params, opt, scene, sky, pix, tgt)
    loss = float(loss)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return loss
