"""Progressive renderer: integrate -> denoise -> accumulate -> pack
(counterpart of ``cpppathtracer_tpu/renderer.py``).

Accumulation follows `Mix` (`cuSrc/path_tracer.cu:241-254`):
  mix = mix + (clamp(frame, 0, 1) - mix) / sample_idx
with sample_idx starting at 1 and reset when the camera moves
(`MotionalCamera::Refresh`).

:func:`frame_step` is the eager frame.  On the card
``ProgressiveRenderer.step`` replays it as one CUDA graph
(``utils/graphs.py``), the counterpart of JAX's jitted `frame_step`
(`renderer.py:98-108`): the samples, the denoiser, the clamp and the mix,
bit for bit the eager frame's.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise
from cpppathtracer_tpu_torch.types import MAX_RECURSION_DEPTH_SET
from cpppathtracer_tpu_torch.utils.graphs import (
    Entry,
    GraphedCall,
    copy_into,
    env_switches,
    signature,
    static_twin,
)
from cpppathtracer_tpu_torch.utils.rng import write_seed


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings (the reference hard-codes them: resolution
    `video_renderer.h:11`, depth `path_tracer.h:43`)."""

    width: int = 1280
    height: int = 720
    max_depth: int = 8
    spp_per_frame: int = 1
    denoise: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.max_depth > MAX_RECURSION_DEPTH_SET:
            raise ValueError(
                f"max_depth {self.max_depth} exceeds hard cap {MAX_RECURSION_DEPTH_SET}"
            )


@dataclasses.dataclass
class AccumulatorState:
    """Progressive accumulation: the running mix and the number of frames
    in it (a host int, so no step waits on the device to read it)."""

    mix: torch.Tensor  # f32[H,W,3]
    sample_idx: int

    @staticmethod
    def create(height: int, width: int, device) -> "AccumulatorState":
        return AccumulatorState(
            mix=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            sample_idx=0,
        )

    def refresh(self) -> "AccumulatorState":
        """Restart accumulation (camera moved): Refresh() semantics."""
        return AccumulatorState(mix=torch.zeros_like(self.mix), sample_idx=0)


def frame_step(scene, camera, sky_tex, state: AccumulatorState, seed,
               max_depth: int, use_denoise: bool, spp: int = 1):
    """One progressive frame: `spp` samples keyed off the accumulation
    index, the optional denoiser, and the running-average mix.  Returns
    (new_state, display image f32[H,W,3] in [0,1])."""
    with torch.no_grad():  # serving: no autograd graph, whatever requires grad
        new_idx = state.sample_idx + 1
        # float(new_idx) as a 0-dim device tensor: a true IEEE division (ops/mathx.div_const)
        divisor = torch.full((), float(new_idx), dtype=torch.float32, device=state.mix.device)
        mixed = _frame(scene, camera, sky_tex, state.mix, state.sample_idx * spp, divisor, seed,
                       max_depth, use_denoise, spp)
    return AccumulatorState(mix=mixed, sample_idx=new_idx), mixed


def _frame(scene, camera, sky_tex, mix, sample_offset, divisor, seed, max_depth, use_denoise,
           spp):
    """A frame's work on the device: the render from `sample_offset` (an
    int, or an i32 device tensor in the frame's CUDA graph), the optional
    denoiser, the clamp, and the running mix with `divisor` (a 0-dim f32
    device tensor).  Returns the new mix."""
    h, w = camera.height, camera.width
    rad, n0, t0 = render_radiance(scene, camera, sky_tex, spp=spp, max_depth=max_depth,
                                  seed=seed, sample_offset=sample_offset)
    rad = rad.reshape(h, w, 3)
    frame = denoise(rad, n0.reshape(h, w, 3), t0.reshape(h, w)) if use_denoise else rad
    return mix + (torch.clamp(frame, 0.0, 1.0) - mix) / divisor


def _host(image) -> np.ndarray:
    return image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)


def to_bgra8(image) -> np.ndarray:
    """f32[H,W,3] in [0,1] to the reference's B,G,R,alpha bytes (x255.99,
    `path_tracer.cu:251-253`)."""
    img = _host(image)
    b = (255.99 * img[..., 2]).astype(np.uint8)
    g = (255.99 * img[..., 1]).astype(np.uint8)
    r = (255.99 * img[..., 0]).astype(np.uint8)
    return np.stack([b, g, r, np.full_like(b, 255)], axis=-1)


def to_rgb8(image) -> np.ndarray:
    return (255.99 * np.clip(_host(image), 0.0, 1.0)).astype(np.uint8)


class ProgressiveRenderer:
    """Host-side loop of the progressive renderer (`include/path_tracer.h:
    17-25`): call `step()` per frame, move the camera through the
    functional ops, read the accumulated frame.  Work is queued on the
    device's stream; `frame()` waits for it."""

    def __init__(self, scene, camera, sky_tex, config: RenderConfig | None = None):
        # Geometry edited by a bare dataclasses.replace leaves attached BVH
        # tables at the old positions, and the walk then returns wrong
        # winners: refit them here, once.
        if scene.bvh_is_stale():
            logging.getLogger(__name__).warning(
                "scene BVH tables are stale (geometry edited after build); refitting: "
                "use Scene.with_geometry to avoid this"
            )
            scene = scene.refit_bvh()
        self.scene = scene
        self.camera = camera
        self.sky_tex = torch.as_tensor(sky_tex, dtype=torch.float32, device=scene.device)
        self.config = config or RenderConfig(width=camera.width, height=camera.height)
        self.state = AccumulatorState.create(camera.height, camera.width, scene.device)
        # the frame graphs (a resize captures another)
        self.graphs = GraphedCall(max_entries=2)

    def move_camera(self, fn, *args, **kw):
        """Apply a camera motion op (e.g. `Camera.move_forward`) and restart
        accumulation."""
        self.camera = fn(self.camera, *args, **kw)
        self.state = self.state.refresh()

    def resize(self, width: int, height: int):
        self.camera = self.camera.resize(width, height)
        self.state = AccumulatorState.create(height, width, self.scene.device)

    def refresh(self):
        self.state = self.state.refresh()

    def step(self):
        """Render one progressive frame into the accumulator; returns the
        display image f32[H,W,3].  On the card the frame is a CUDA graph
        (:meth:`step_graphed`); on the CPU :func:`frame_step`, which is
        also the eager form to call for debugging on the card."""
        if self.scene.device.type == "cuda":
            return self.step_graphed()
        self.state, image = frame_step(
            self.scene, self.camera, self.sky_tex, self.state, self.config.seed,
            self.config.max_depth, self.config.denoise, self.config.spp_per_frame,
        )
        return image

    def frame_key(self):
        """The cache key of this renderer's frame graph: every input's
        shape and dtype (the resolution among them), the config but its
        seed (a replay reads the seed from a buffer, as JAX traces it) and
        the POCA_* switches that choose the route."""
        return ("frame", signature((self.scene, self.camera, self.sky_tex)),
                dataclasses.astuple(dataclasses.replace(self.config, seed=0)), env_switches())

    def step_graphed(self):
        """One frame through the captured graph of :meth:`frame_key`,
        captured on first use (by :attr:`graphs`' backend): the current
        scene, camera, sky and mix are copied into its buffers, the sample
        key and the mix divisor are written from ``state.sample_idx``, the
        seed from the config, and it replays.  Afterwards ``state.mix`` is
        the graph's mix buffer, which the next step overwrites; the image
        returned is a copy."""
        cfg = self.config
        inputs = (self.scene, self.camera, self.sky_tex)
        e = self.graphs.entry(self.frame_key(), lambda r: _capture_frame(r, inputs, cfg))
        copy_into(e.inputs, inputs)
        if self.state.mix is not e.mix:
            e.mix.copy_(self.state.mix)
        new_idx = self.state.sample_idx + 1
        e.key.fill_(self.state.sample_idx * cfg.spp_per_frame)
        e.div.fill_(float(new_idx))
        write_seed(e.seed, cfg.seed)
        e.graphs[0].replay()
        self.state = AccumulatorState(mix=e.mix, sample_idx=new_idx)
        return e.mix.clone()

    def frame(self) -> np.ndarray:
        """The accumulated frame as float RGB [H,W,3] (waits for the device)."""
        return _host(self.state.mix)


def _capture_frame(runner, inputs, cfg: RenderConfig):
    """The entry of one frame key: static scene, camera and sky, the sample
    key, seed, mix divisor and mix buffers, and the graph of
    :func:`frame_step`'s work on them."""
    e = Entry()
    e.inputs = static_twin(inputs)
    scene, camera, sky_tex = e.inputs
    dev = scene.device
    e.key = torch.zeros((), dtype=torch.int32, device=dev)
    e.seed = torch.zeros((), dtype=torch.int32, device=dev)
    e.div = torch.ones((), dtype=torch.float32, device=dev)
    e.mix = torch.zeros((camera.height, camera.width, 3), dtype=torch.float32, device=dev)

    def frame():
        with torch.no_grad():
            e.mix.copy_(_frame(scene, camera, sky_tex, e.mix, e.key, e.div, e.seed,
                               cfg.max_depth, cfg.denoise, cfg.spp_per_frame))

    e.graphs = runner.capture(frame, device=dev)
    return e
