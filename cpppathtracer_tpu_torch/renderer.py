"""Progressive renderer: integrate -> denoise -> accumulate -> pack
(counterpart of ``cpppathtracer_tpu/renderer.py``).

Accumulation follows `Mix` (`cuSrc/path_tracer.cu:241-254`):
  mix = mix + (clamp(frame, 0, 1) - mix) / sample_idx
with sample_idx starting at 1 and reset when the camera moves
(`MotionalCamera::Refresh`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpppathtracer_tpu_torch.integrator import render_radiance
from cpppathtracer_tpu_torch.ops.denoise import denoise
from cpppathtracer_tpu_torch.ops.mathx import div_const
from cpppathtracer_tpu_torch.types import MAX_RECURSION_DEPTH_SET


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


def frame_step(scene, camera, sky_tex, state: AccumulatorState, seed: int,
               max_depth: int, use_denoise: bool, spp: int = 1):
    """One progressive frame: `spp` samples keyed off the accumulation
    index, the optional denoiser, and the running-average mix.  Returns
    (new_state, display image f32[H,W,3] in [0,1])."""
    h, w = camera.height, camera.width
    rad, n0, t0 = render_radiance(
        scene, camera, sky_tex, spp=spp, max_depth=max_depth, seed=seed,
        sample_offset=state.sample_idx * spp,
    )
    rad = rad.reshape(h, w, 3)
    frame = denoise(rad, n0.reshape(h, w, 3), t0.reshape(h, w)) if use_denoise else rad
    new_idx = state.sample_idx + 1
    mixed = state.mix + div_const(torch.clamp(frame, 0.0, 1.0) - state.mix, float(new_idx))
    return AccumulatorState(mix=mixed, sample_idx=new_idx), mixed


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
        self.scene = scene
        self.camera = camera
        self.sky_tex = torch.as_tensor(sky_tex, dtype=torch.float32, device=scene.device)
        self.config = config or RenderConfig(width=camera.width, height=camera.height)
        self.state = AccumulatorState.create(camera.height, camera.width, scene.device)

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
        """Render one progressive frame into the accumulator."""
        self.state, image = frame_step(
            self.scene, self.camera, self.sky_tex, self.state, self.config.seed,
            self.config.max_depth, self.config.denoise, self.config.spp_per_frame,
        )
        return image

    def frame(self) -> np.ndarray:
        """The accumulated frame as float RGB [H,W,3] (waits for the device)."""
        return _host(self.state.mix)
