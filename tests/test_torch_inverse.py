"""inverse.fit on the port, on the CPU: the optimizer recovers a perturbed
albedo (tests/test_inverse.py:32), and its first losses match the JAX
package's fit step for step."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from cpppathtracer_tpu.integrator import render_radiance as j_render_radiance
from cpppathtracer_tpu.inverse import InverseConfig as JInverseConfig
from cpppathtracer_tpu.inverse import fit as j_fit
from cpppathtracer_tpu.models.camera import Camera as JCamera
from cpppathtracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cpppathtracer_tpu.ops.texture import procedural_sky
from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.inverse import InverseConfig, fit

from torch_port_helpers import controlled_scene, port_camera, port_scene, port_sky

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_fit_recovers_albedo():
    """tests/test_inverse.py:32 on the port: 60 Adam steps from a wrong
    sphere albedo bring the loss under 5% of its start and the albedo
    within 0.05."""
    b = JSceneBuilder()
    b.add_platform(0.0, kd=(0.8, 0.8, 0.8))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, kd=(0.7, 0.3, 0.2))
    scene_true = port_scene(b.build())
    cam = port_camera(JCamera.make(16, 12, origin=(0.0, 4.0, -11.0), look_at=(0.0, 2.0, 0.0),
                                   view_fov=40.0, lens_radius=0.0))
    sky = port_sky(procedural_sky(32, 32, seed=4))
    cfg = InverseConfig(spp=2, max_depth=3, fields=("kd",), learning_rate=0.1, fixed_samples=True)
    with torch.no_grad():
        target = render_radiance(scene_true, cam, sky, spp=2, max_depth=3)[0]
    kd = scene_true.kd.clone()
    kd[1] = torch.tensor([0.3, 0.6, 0.6])
    fitted, losses = fit(dataclasses.replace(scene_true, kd=kd), cam, sky, target, cfg, steps=60)
    assert losses[-1] < losses[0] * 0.05, losses[::10]
    np.testing.assert_allclose(fitted.kd[1].numpy(), scene_true.kd[1].numpy(), atol=0.05)


def test_fit_first_losses_match_jax():
    """Three steps of fit with InverseConfig's default fields and Adam on
    the controlled scene (12x8, 1 spp, depth 2, fixed samples, every
    albedo perturbed): the losses match the JAX package's within 1e-3
    relative (measured 6e-6).  The view is one where every pixel's path
    is the same in both packages (no lens jitter).  Every albedo is off,
    so every optimized entry has a real gradient: Adam divides each step
    by the root of its squared gradient, and an entry whose gradient is
    float32 noise around a true 0 would step in a direction that rounding
    decides."""
    jcam = JCamera.make(12, 8, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0),
                        view_fov=40.0, lens_radius=0.0)
    sky = procedural_sky(16, 16)
    jscene = controlled_scene()
    target = np.asarray(j_render_radiance(jscene, jcam, jnp.asarray(sky), spp=1, max_depth=2,
                                          seed=0)[0])
    kd = np.asarray(jscene.kd) + np.random.RandomState(5).uniform(-0.15, 0.15, (5, 3))
    j0 = dataclasses.replace(jscene, kd=jnp.asarray(kd, jnp.float32))
    scene0 = port_scene(j0)  # before j_fit, which donates j0's material arrays
    _, losses_j = j_fit(j0, jcam, jnp.asarray(sky), target,
                        JInverseConfig(spp=1, max_depth=2, fixed_samples=True), steps=3)
    cfg = InverseConfig(spp=1, max_depth=2, fixed_samples=True)
    _, losses = fit(scene0, port_camera(jcam), port_sky(sky), _t(target), cfg, steps=3)
    assert losses[2] < losses[0]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-3)


def test_fit_optimizes_sky():
    """optimize_sky adds the sky texture to the parameters: two steps
    toward a brighter sky move it and lower the loss."""
    scene = port_scene(controlled_scene())
    cam = port_camera(JCamera.make(8, 6, origin=(0.0, 4.0, -14.0), look_at=(0.0, 1.5, 0.0)))
    sky = port_sky(procedural_sky(8, 8))
    with torch.no_grad():
        target = render_radiance(scene, cam, sky * 1.2, spp=1, max_depth=2)[0]
    seen = []
    cfg = InverseConfig(spp=1, max_depth=2, fields=("kd",), optimize_sky=True, fixed_samples=True)
    _, losses = fit(scene, cam, sky, target, cfg, steps=2,
                    callback=lambda step, loss, params: seen.append(params["sky"].detach().clone()))
    assert losses[1] < losses[0]
    assert not torch.equal(seen[0], sky) and len(seen) == 2
