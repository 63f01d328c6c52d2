"""The plain reference of the progressive viewer's frame: the camera's
motion ops, the edge-avoiding 5x5 denoiser at chosen pixels, and the
running mix of clamped frames.

Motion follows `MotionalCamera` (`cuSrc/motional_camera.cu:76-168`): a move
shifts origin and look-at by coefficient * move_speed along the camera's
left, back or up axis; a rotation nudges the look direction along up or
left.  The denoiser follows `Denoising` (`cuSrc/path_tracer.cu:177-239`):
fixed 5x5 Gaussian tap weights times exp(-d^2 / pi) of the colour, normal
and depth differences, taps outside the image with no weight.  The mix
follows `Mix` (`path_tracer.cu:241-254`): the mean of the frames since the
last camera move, each clamped to [0, 1].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.tracer import INF

KERNEL_5X5 = np.array([[1.0, 4.0, 7.0, 4.0, 1.0], [4.0, 16.0, 26.0, 16.0, 4.0],
                       [7.0, 26.0, 41.0, 26.0, 7.0], [4.0, 16.0, 26.0, 16.0, 4.0],
                       [1.0, 4.0, 7.0, 4.0, 1.0]])
MOVE_SPEED = 50.0


def _normalize(v):
    n2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    inv = torch.where(n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-12)), torch.zeros_like(n2))
    return v * inv


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


class Pose:
    """A camera's origin, look-at and fov as float32 3-vectors on a device,
    moved by the viewer's ops."""

    def __init__(self, origin, look_at, view_fov, device):
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        self.origin, self.look_at, self.view_fov = f(origin), f(look_at), float(view_fov)
        self.speed = f(MOVE_SPEED)
        self.vup = torch.eye(3, dtype=torch.float32, device=device)[1]

    def _left(self):
        return -_normalize(_cross(self.vup, _normalize(self.origin - self.look_at)))

    def _shift(self, d):
        self.origin, self.look_at = self.origin + d, self.look_at + d

    def apply(self, op: str, arg: float):
        c = arg * self.speed
        if op == "move_left":
            self._shift(c * self._left())
        elif op == "move_right":
            self._shift(-(c * self._left()))
        elif op in ("move_forward", "move_backward"):
            back = -_normalize(_cross(self._left(), self.vup))
            self._shift(-(c * back) if op == "move_forward" else c * back)
        elif op == "move_up":
            self._shift(c * self.vup)
        elif op == "move_down":
            self._shift(-(c * self.vup))
        elif op in ("rotate_left", "rotate_right", "rotate_up", "rotate_down"):
            du = arg if op == "rotate_up" else -arg if op == "rotate_down" else 0.0
            dl = arg if op == "rotate_left" else -arg if op == "rotate_right" else 0.0
            look = self.origin + _normalize(self.look_at - self.origin)
            w = _normalize(look - self.origin)
            left = _normalize(_cross(self.vup, w))
            up = _normalize(_cross(w, left))
            look = look + du * up + dl * left
            self.look_at = self.origin + _normalize(look - self.origin)
        else:
            raise ValueError(f"unknown camera op {op!r}")

    def snapshot(self):
        return (self.origin.cpu().numpy().tolist(), self.look_at.cpu().numpy().tolist(),
                self.view_fov)


def neighbourhood(ys, xs, h: int, w: int, stepwidth: int = 1):
    """The distinct flat pixel indices of the 5x5 taps around each centre,
    inside the image."""
    taps = []
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            yy, xx = ys + dy * stepwidth, xs + dx * stepwidth
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            taps.append((yy * w + xx)[ok])
    return torch.unique(torch.cat(taps))


def denoise_at(rad, normal, depth, ys, xs, stepwidth: int = 1):
    """The denoised colour f[P, 3] at centres (ys, xs) from full-size
    buffers rad and normal f[H, W, 3], depth f[H, W] (the taps' values
    must be filled in; others are not read)."""
    h, w = depth.shape
    num = torch.zeros((ys.shape[0], 3), dtype=rad.dtype, device=rad.device)
    den = torch.zeros((ys.shape[0], 1), dtype=rad.dtype, device=rad.device)
    c0, n0, t0 = rad[ys, xs], normal[ys, xs], depth[ys, xs]
    sq = lambda v: v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
    for i in range(5):
        for j in range(5):
            yy, xx = ys + (j - 2) * stepwidth, xs + (i - 2) * stepwidth
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yc, xc = yy.clamp(0, h - 1), xx.clamp(0, w - 1)
            c, n, t = rad[yc, xc], normal[yc, xc], depth[yc, xc]
            wgt = (torch.exp(-sq(c0 - c) / math.pi) * torch.exp(-sq(n0 - n) / math.pi)
                   * torch.exp(-((t0 - t) * (t0 - t)) / math.pi) * KERNEL_5X5[i, j]
                   * ok.to(rad.dtype))[:, None]
            num = num + wgt * c
            den = den + wgt
    return num / den


def full_buffers(h: int, w: int, pix, rad, first_n, first_t, dtype):
    """Full-size buffers holding the traced pixels' values (misses' depth
    INF elsewhere)."""
    dev = pix.device
    r = torch.zeros((h * w, 3), dtype=dtype, device=dev)
    n = torch.zeros((h * w, 3), dtype=dtype, device=dev)
    t = torch.full((h * w,), INF, dtype=dtype, device=dev)
    r[pix.long()] = rad.to(dtype)
    n[pix.long()] = first_n.to(dtype)
    t[pix.long()] = first_t.to(dtype)
    return r.reshape(h, w, 3), n.reshape(h, w, 3), t.reshape(h, w)
