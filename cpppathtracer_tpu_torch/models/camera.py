"""Thin-lens fly camera (counterpart of
``cpppathtracer_tpu/models/camera.py``).

Numerics follow `MotionalCamera::GetCopy` / `RayGen`
(`cuSrc/motional_camera.cu:177-213`):
  theta = fov * pi/180; half_h = tan(theta/2); half_w = aspect * half_h
  w = normalize(origin - look_at); u = normalize(cross(vup, w)); v = w x u
  ray.origin = origin + lens_radius*(r1*u + r2*v)   (r uniform in [0,1)^2)
  ray.dir = normalize(top_left + (x/W)*horizontal + (y/H)*vertical
                      - origin - offset)
There is no sub-pixel jitter in the reference; motion ops return a new
camera.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cpppathtracer_tpu_torch.ops.mathx import EPS, clamp, div_const
from cpppathtracer_tpu_torch.types import INF, Rays, resolve_device
from cpppathtracer_tpu_torch.utils import rng as prng


def _normalize(v):
    n2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    inv = torch.where(n2 > 0, 1.0 / torch.sqrt(clamp(n2, lo=EPS)), torch.zeros_like(n2))
    return v * inv


def _length(v):
    return torch.sqrt(clamp(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], lo=0.0))


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


@dataclasses.dataclass
class Camera:
    origin: torch.Tensor  # f32[3]
    look_at: torch.Tensor  # f32[3]
    view_fov: torch.Tensor  # f32[] degrees (default 30)
    lens_radius: torch.Tensor  # f32[] (default 5e-4)
    move_speed: torch.Tensor  # f32[] (default 50)
    width: int
    height: int

    @staticmethod
    def make(width, height, origin=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, 1.0),
             view_fov=30.0, lens_radius=5e-4, move_speed=50.0, device=None) -> "Camera":
        dev = resolve_device(device)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return Camera(
            origin=f(origin), look_at=f(look_at), view_fov=f(view_fov),
            lens_radius=f(lens_radius), move_speed=f(move_speed),
            width=int(width), height=int(height),
        )

    @property
    def device(self) -> torch.device:
        return self.origin.device

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def _vup(self):
        # a device kernel, not a host-to-device copy: basis() runs inside CUDA graphs
        return torch.eye(3, dtype=torch.float32, device=self.device)[1]

    def basis(self):
        """(u, v, w, top_left, horizontal, vertical), f32[3] each."""
        f = lambda v: torch.full((), v, dtype=torch.float32, device=self.device)
        theta = self.view_fov * (math.pi / 180.0)
        aspect = f(self.width) / f(self.height)
        half_h = torch.tan(theta / 2.0)
        half_w = aspect * half_h
        w = _normalize(self.origin - self.look_at)
        u = _normalize(_cross(self._vup(), w))
        v = _cross(w, u)
        focus = _length(self.origin - self.look_at)
        top_left = self.origin - half_w * focus * u + half_h * focus * v - focus * w
        horizontal = 2.0 * half_w * focus * u
        vertical = -2.0 * half_h * focus * v
        return u, v, w, top_left, horizontal, vertical

    def ray_gen_planar(self, pixel_idx, sample_idx, seed):
        """Primary rays for flat pixel indices (i32[R], row-major y*W+x) at
        sample `sample_idx` (int or i32[R]) and `seed` (int, or an i32
        tensor of one element on the pixels' device: a graph's seed
        buffer): (o, d), tuples of three flat f32[R] tensors."""
        u, v, _w, top_left, horizontal, vertical = self.basis()
        x = (pixel_idx % self.width).to(torch.float32)
        y = torch.div(pixel_idx, self.width, rounding_mode="floor").to(torch.float32)
        r1, r2, _r3, _r4 = prng.uniforms4(seed, pixel_idx, sample_idx, prng.CTR_RAYGEN)
        rd_x = self.lens_radius * r1
        rd_y = self.lens_radius * r2
        dx = div_const(x, float(self.width))
        dy = div_const(y, float(self.height))
        o = tuple(self.origin[c] + (rd_x * u[c] + rd_y * v[c]) for c in range(3))
        t_rel = tuple(
            top_left[c] + dx * horizontal[c] + dy * vertical[c]
            - self.origin[c] - (rd_x * u[c] + rd_y * v[c])
            for c in range(3)
        )
        n2 = t_rel[0] * t_rel[0] + t_rel[1] * t_rel[1] + t_rel[2] * t_rel[2]
        inv = torch.where(n2 > 0, 1.0 / torch.sqrt(clamp(n2, lo=EPS)), torch.zeros_like(n2))
        return o, tuple(t * inv for t in t_rel)

    def ray_gen(self, pixel_idx, sample_idx, seed) -> Rays:
        """Row-major form of :meth:`ray_gen_planar` for pixel indices of any
        shape: `Rays` with origin and dir f32[..., 3] (the planar values,
        stacked), tmin 0 and tmax DEFAULT_RAY_TMAX."""
        o, d = self.ray_gen_planar(pixel_idx, sample_idx, seed)
        zero = torch.zeros_like(o[0])
        return Rays(torch.stack(o, dim=-1), torch.stack(d, dim=-1), zero, zero + INF)

    # interactive motion (motional_camera.cu:76-168); each op returns a new
    # camera and the caller restarts accumulation
    def _left(self):
        w = _normalize(self.origin - self.look_at)
        return -_normalize(_cross(self._vup(), w))

    def _moved(self, d) -> "Camera":
        return self.replace(origin=self.origin + d, look_at=self.look_at + d)

    def move_left(self, coefficient=1.0) -> "Camera":
        return self._moved(coefficient * self.move_speed * self._left())

    def move_right(self, coefficient=1.0) -> "Camera":
        return self._moved(-(coefficient * self.move_speed * self._left()))

    def _back(self):
        return -_normalize(_cross(self._left(), self._vup()))

    def move_forward(self, coefficient=1.0) -> "Camera":
        return self._moved(-(coefficient * self.move_speed * self._back()))

    def move_backward(self, coefficient=1.0) -> "Camera":
        return self._moved(coefficient * self.move_speed * self._back())

    def move_up(self, coefficient=1.0) -> "Camera":
        return self._moved(coefficient * self.move_speed * self._vup())

    def move_down(self, coefficient=1.0) -> "Camera":
        return self._moved(-(coefficient * self.move_speed * self._vup()))

    def _rotate(self, delta_up, delta_left) -> "Camera":
        look = self.origin + _normalize(self.look_at - self.origin)
        w = _normalize(look - self.origin)
        left = _normalize(_cross(self._vup(), w))
        up = _normalize(_cross(w, left))
        look = look + delta_up * up + delta_left * left
        return self.replace(look_at=self.origin + _normalize(look - self.origin))

    def rotate_up(self, dy) -> "Camera":
        return self._rotate(float(dy), 0.0)

    def rotate_down(self, dy) -> "Camera":
        return self._rotate(-float(dy), 0.0)

    def rotate_left(self, dx) -> "Camera":
        return self._rotate(0.0, float(dx))

    def rotate_right(self, dx) -> "Camera":
        return self._rotate(0.0, -float(dx))

    def scale_fov(self, d) -> "Camera":
        """Adds d * pi/180 to the fov *in degrees*: the reference mixes
        units (`motional_camera.cu:166-168`) and the port keeps it."""
        d32 = torch.full((), float(d), dtype=torch.float32, device=self.device)
        return self.replace(view_fov=self.view_fov + div_const(d32 * math.pi, 180.0))

    def resize(self, width, height) -> "Camera":
        return self.replace(width=int(width), height=int(height))
