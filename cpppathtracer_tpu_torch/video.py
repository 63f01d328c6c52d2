"""Animated-camera video rendering (counterpart of
``cpppathtracer_tpu/video.py``): a camera path is a list of camera states;
frames render on the device (optionally tiled over a mesh) and stream to
disk as PNGs through a writer thread.

The reference's pipeline thread (`path_tracer.cu:256-319`) maps to
PyTorch's asynchronous launches: the render thread queues the next frame's
kernels while the writer thread copies the previous frame to the host and
encodes it.

On the card a frame is compiled, as JAX jits its frame program
(`video.py:118-146`): one entry of CUDA graphs (:data:`VIDEO_GRAPHS`) does
the render's chunks and then the denoiser and the 8-bit pack; frame i
copies its camera into the entry's buffers, writes seed + i into its seed
word and replays, so a whole path replays one capture.  With a mesh the
tiles replay their own graphs (``parallel.render.tile_graphs``) and the
denoise and pack run as one graph on the mesh's first device (JAX's jitted
`_denoise`).  On the CPU the frames render eagerly, one PyTorch operation
at a time (:func:`write_frames` with no runner, also the form to debug
with on the card).
"""

from __future__ import annotations

import os
import queue
import threading
from collections.abc import Iterable, Sequence

import numpy as np
import torch

from cpppathtracer_tpu_torch.integrator import render_radiance, render_replay
from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise
from cpppathtracer_tpu_torch.ops.mathx import div_const
from cpppathtracer_tpu_torch.parallel.render import render_tiles, tile_graphs
from cpppathtracer_tpu_torch.utils import obs
from cpppathtracer_tpu_torch.utils.graphs import Entry, GraphedCall, copy_into, signature, static_twin
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

    A queued frame may be a CUDA tensor: :meth:`put` records an event on
    the stream that made it (the render thread's current stream, which
    need not be the writer's), the writer waits for the event before its
    ``.cpu()``, and the queue's reference keeps the caching allocator from
    reusing the frame's memory until then.  A failed write is kept and raised by the next :meth:`put` and by
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
            idx, img, made = item
            try:
                if made is not None:
                    made.synchronize()
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
        made = None
        if isinstance(image, torch.Tensor) and image.is_cuda:
            made = torch.cuda.Event()
            made.record(torch.cuda.current_stream(image.device))
        self._q.put((idx, image, made))

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


# The CUDA graphs of render_video's frames, as jax.jit caches its programs:
# a frame's render, denoise and pack, and a mesh frame's denoise and pack;
# VIDEO_GRAPHS.clear() frees them.
VIDEO_GRAPHS = GraphedCall(max_entries=2)


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
    (``parallel.render.render_image_sharded``).  On the card every frame
    replays the compiled frame of :data:`VIDEO_GRAPHS` (module docstring);
    on the CPU the frames render eagerly."""
    runner = None if scene.device.type == "cpu" else VIDEO_GRAPHS
    return write_frames(runner, scene, cameras, sky_tex, out_dir, spp=spp, max_depth=max_depth,
                        seed=seed, mesh=mesh, denoise_frames=denoise_frames)


def write_frames(runner, scene, cameras, sky_tex, out_dir: str, *, spp: int = 8,
                 max_depth: int = 8, seed: int = 0, mesh=None,
                 denoise_frames: bool = True) -> list[str]:
    """:func:`render_video`'s body.  With `runner` (a ``GraphedCall``,
    whose backend decides what a capture is) each frame replays its
    graphs, and a mesh's tiles those of ``tile_graphs(mesh)``; with None
    each frame is ``render_radiance`` (or the eager tiles) and
    :func:`frame_rgb8`.  Every frame handed to the writer is a tensor of
    its own, never a graph's buffer that the next replay overwrites."""
    sky_tex = torch.as_tensor(sky_tex, dtype=torch.float32, device=scene.device)
    sink = AsyncFrameSink(out_dir)
    paths = []
    try:
        with torch.no_grad():  # serving
            for i, cam in enumerate(cameras):
                if mesh is not None:
                    tiles = None if runner is None else tile_graphs(mesh, runner.backend)
                    rad, n0, t0 = render_tiles(tiles, scene, cam, sky_tex, mesh, spp=spp,
                                               max_depth=max_depth, seed=seed + i)
                    img = (frame_rgb8(rad, n0, t0, denoise_frames) if runner is None else
                           _pack_graphed(runner, rad, n0, t0, denoise_frames))
                else:
                    img = render_frame(runner, scene, cam, sky_tex, seed + i, spp=spp,
                                       max_depth=max_depth, use_denoise=denoise_frames)
                sink.put(i, img)
                paths.append(sink.path(i))
    finally:
        sink.close()
    return paths


def render_frame(runner, scene, camera, sky_tex, seed, *, spp: int, max_depth: int,
                 use_denoise: bool = True):
    """One frame of the video, JAX's `_frame_rgb8` (`video.py:131-146`):
    the render at `seed`, the denoiser and the 8-bit pack, uint8[H, W, 3]
    on the scene's device.  With `runner`, a replay of its frame entry
    (the render's chunk graphs, then the denoise and pack as one more
    graph), the frame a copy of the entry's output buffer; with None,
    ``render_radiance`` and :func:`frame_rgb8`, eagerly."""
    h, w = camera.height, camera.width
    if runner is None:
        rad, n0, t0 = render_radiance(scene, camera, sky_tex, spp=spp, max_depth=max_depth,
                                      seed=seed)
        return frame_rgb8(rad.reshape(h, w, 3), n0.reshape(h, w, 3), t0.reshape(h, w),
                          use_denoise)

    def pack(e):
        e.rgb8 = torch.empty((h, w, 3), dtype=torch.uint8, device=e.acc.device)

        def body():
            rad = div_const(e.acc, float(spp)).reshape(h, w, 3)
            e.rgb8.copy_(frame_rgb8(rad, e.first_n.reshape(h, w, 3), e.first_t.reshape(h, w),
                                    use_denoise))

        return body

    e = render_replay(runner, scene, camera, sky_tex, spp=spp, max_depth=max_depth, seed=seed,
                      tail=(("rgb8", use_denoise), pack))
    return e.rgb8.clone()


def _pack_graphed(runner, rad, n0, t0, use_denoise):
    """A tiled frame's denoise and pack as one graph of `runner` on the
    frame's device, keyed by its shape: a copy of its uint8 frame."""
    inputs = (rad, n0, t0)

    def build(r):
        e = Entry()
        e.inputs = static_twin(inputs)
        e.rgb8 = torch.empty(rad.shape, dtype=torch.uint8, device=rad.device)

        def body():
            e.rgb8.copy_(frame_rgb8(*e.inputs, use_denoise))

        e.graphs = r.capture(body, device=rad.device)
        return e

    e = runner.entry(lambda: ("pack", signature(inputs), use_denoise), build)
    with obs.span("graphs.copy_in") as sp:
        copy_into(e.inputs, inputs, sp)
    e.graphs[0].replay()
    return e.rgb8.clone()
