"""Animated-camera video rendering (counterpart of
``cpppathtracer_tpu/video.py``): a camera path is a list of camera states;
frames render on the device (optionally tiled over a mesh) and stream to
disk as PNGs through a writer thread.

The reference's pipeline thread (`path_tracer.cu:256-319`) maps to
PyTorch's asynchronous launches: the render thread queues the next frame's
kernels while the writer thread copies the previous frame to the host and
encodes it.
"""

from __future__ import annotations

import os
import queue
import threading
from collections.abc import Iterable, Sequence

import numpy as np
import torch

from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise
from cpppathtracer_tpu_torch.parallel.render import render_image_sharded
from cpppathtracer_tpu_torch.utils.png import write_png


def orbit_path(camera: Camera, frames: int, degrees: float = 360.0) -> list[Camera]:
    """An orbit of the camera origin around its look-at point (numpy
    float32 arithmetic, as the JAX package's)."""
    out = []
    origin = camera.origin.detach().cpu().numpy().astype(np.float32)
    look = camera.look_at.detach().cpu().numpy().astype(np.float32)
    rel = origin - look
    for i in range(frames):
        ang = np.deg2rad(degrees) * i / frames
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([rel[0] * c + rel[2] * s, rel[1], -rel[0] * s + rel[2] * c], np.float32)
        out.append(camera.replace(origin=torch.from_numpy(look + rot).to(camera.device)))
    return out


def fly_path(camera: Camera, frames: int, keys: str = "w") -> list[Camera]:
    """A path from repeated key-style motion (the WASDQE semantics of
    `VideoRenderer::OnKeyDown`, normalised diagonal speed included)."""
    out = []
    cam = camera
    for _ in range(frames):
        l_r = keys.count("a") - keys.count("d")
        f_b = keys.count("w") - keys.count("s")
        u_d = keys.count("q") - keys.count("e")
        div = max(np.sqrt(float(l_r**2 + f_b**2 + u_d**2)), 1.0)
        if l_r:
            cam = cam.move_left(l_r / div * 0.02)
        if f_b:
            cam = cam.move_forward(f_b / div * 0.02)
        if u_d:
            cam = cam.move_up(u_d / div * 0.02)
        out.append(cam)
    return out


class AsyncFrameSink:
    """Writer thread: frames queue here and are copied to the host and
    encoded to PNG off the render thread.

    A queued frame may be a CUDA tensor; the writer's ``.cpu()`` waits on
    the device's default stream, where the frame was made, and the queue's
    reference keeps the caching allocator from reusing its memory until
    then.  A failed write is kept and raised by the next :meth:`put` and by
    :meth:`close`; the writer goes on draining the queue, so a full queue
    never blocks the renderer."""

    def __init__(self, out_dir: str, prefix: str = "frame"):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.prefix = prefix
        self._error: Exception | None = None
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def path(self, idx: int) -> str:
        return os.path.join(self.out_dir, f"{self.prefix}_{idx:05d}.png")

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._error is not None:
                continue
            idx, img = item
            try:
                if isinstance(img, torch.Tensor):
                    img = img.cpu()
                write_png(self.path(idx), img)
            except Exception as e:  # noqa: BLE001 — kept and raised on the render thread
                self._error = e

    def _raise(self):
        if self._error is not None:
            raise RuntimeError(f"frame writer failed: {self._error!r}") from self._error

    def put(self, idx: int, image):
        self._raise()
        self._q.put((idx, image))

    def close(self):
        self._q.put(None)
        self._thread.join()
        self._raise()


def frame_rgb8(rad, n0, t0, use_denoise: bool = True):
    """A frame's radiance f32[H, W, 3] (with its first-hit normal [H, W, 3]
    and depth [H, W]) -> uint8 RGB on its device: the denoiser, then
    255.99 * clamp(x, 0, 1) truncated."""
    frame = denoise(rad, n0, t0) if use_denoise else rad
    return (255.99 * torch.clamp(frame, 0.0, 1.0)).to(torch.uint8)


def render_video(
    scene,
    cameras: Sequence[Camera] | Iterable[Camera],
    sky_tex,
    out_dir: str,
    *,
    spp: int = 8,
    max_depth: int = 8,
    seed: int = 0,
    mesh=None,
    denoise_frames: bool = True,
) -> list[str]:
    """Render a camera path to PNG frames (frame i with seed + i).  With
    `mesh`, each frame is tiled over the mesh
    (``parallel.render.render_image_sharded``)."""
    sky_tex = torch.as_tensor(sky_tex, dtype=torch.float32, device=scene.device)
    sink = AsyncFrameSink(out_dir)
    paths = []
    try:
        with torch.no_grad():  # serving
            for i, cam in enumerate(cameras):
                h, w = cam.height, cam.width
                if mesh is not None:
                    rad, n0, t0 = render_image_sharded(
                        scene, cam, sky_tex, mesh, spp=spp, max_depth=max_depth, seed=seed + i
                    )
                else:
                    rad, n0, t0 = render_radiance(
                        scene, cam, sky_tex, spp=spp, max_depth=max_depth, seed=seed + i
                    )
                    rad, n0, t0 = rad.reshape(h, w, 3), n0.reshape(h, w, 3), t0.reshape(h, w)
                sink.put(i, frame_rgb8(rad, n0, t0, denoise_frames))
                paths.append(sink.path(i))
    finally:
        sink.close()
    return paths
