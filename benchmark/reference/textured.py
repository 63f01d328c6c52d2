"""The plain reference of the textured gradient step: the albedo of an
object whose tex_id is t >= 0 is texture t of a stack f32[T, H, W, 3]
sampled at the hit's UV, and the loss `sum(rad^2)` of a render is
differentiated with respect to kd, emission and the stack.

Written again here, so that the yardstick does not move with the program:
- the UV of a hit on its object, as the JAX package defines it
  (`cpppathtracer_tpu/ops/uv.py`; the reference's `Object::ClosetHit`
  passes no UV at all): a sphere u = atan2(p.z - c.z, p.x - c.x) / 2pi +
  0.5, v = asin(clamp((p.y - c.y) / r)) / pi + 0.5; a platform u = 0.01 p.x,
  v = 0.01 p.z; a cylinder the sphere's u and v = (p.y - y_bot) / height,
  a zero radius or height taken as 1;
- the bilinear fetch of CUDA's texture unit as the reference configures it
  (`textures.cu:44-71`): normalised coordinates, the four taps around
  (u W - 0.5, v H - 0.5), mirror addressing.

A path's geometry does not depend on the albedo, so the paths traced once
(`tracer.trace(record=True)`, which keeps each bounce's hit position on a
textured scene) are replayed by `tracer.replay_radiance` with the textured
albedo in the attenuation; the emission term keeps the raw kd
(`material.cu:36`).  The replay and its gradients are taken in float64 for
the float32 reference (the stack, kd and emission as float64 leaves) and in
the control's own dtype otherwise, in blocks of rows.  Nothing of the
program is imported.

`fault` plants one of the faults the comparison must reject:
`no_texture` (the albedo kd, as if the stack were not passed),
`clamp_taps` (clamp addressing in place of mirror) and `half_batch` (the
loss over the first half of the pixels only).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import tracer

FAULTS = ("no_texture", "clamp_taps", "half_batch")
ROWS = 1 << 18  # rows of one block of the replay


def surface_uv(prim, center, radius, height, pos):
    """(u, v) of hit positions `pos` (planar) on objects of types `prim`
    with `center` (planar), `radius` and `height`, in their dtype."""
    cx, cy, cz = center
    px, py, pz = pos
    relx, rely, relz = px - cx, py - cy, pz - cz
    su = tracer.div_exact(torch.atan2(relz, relx), 2.0 * math.pi) + 0.5
    safe_r = torch.where(radius == 0.0, torch.ones_like(radius), radius)
    sv = tracer.div_exact(torch.asin(torch.clamp(rely / safe_r, -1.0, 1.0)), math.pi) + 0.5
    safe_h = torch.where(height == 0.0, torch.ones_like(height), height)
    cv = (py - (cy - height / 2.0)) / safe_h
    sph, pla = prim == 0, prim == 1
    u = torch.where(sph, su, torch.where(pla, px * 0.01, su))
    v = torch.where(sph, sv, torch.where(pla, pz * 0.01, cv))
    return u, v


def _clamp(i, n):
    return i.clamp(0, n - 1)


def bilinear(stack, t, u, v, address: str = "mirror"):
    """Texture t (int64 per row) of `stack` f[T, H, W, 3] at normalised
    (u, v): the four taps around (u W - 0.5, v H - 0.5) with mirror (or
    clamp) addressing, weighted bilinearly; f[R, 3] in the stack's dtype,
    differentiable in the stack."""
    n_t, h, w = stack.shape[0], stack.shape[1], stack.shape[2]
    flat = stack.reshape(n_t * h * w, 3)
    u, v = u.to(stack.dtype), v.to(stack.dtype)
    xb = u * w - 0.5
    yb = v * h - 0.5
    x0f, y0f = torch.floor(xb), torch.floor(yb)
    fx, fy = (xb - x0f)[:, None], (yb - y0f)[:, None]
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    wrap = tracer._mirror if address == "mirror" else _clamp
    base = t * (h * w)
    tap = lambda yy, xx: flat.index_select(0, base + wrap(yy, h) * w + wrap(xx, w))
    top = tap(y0, x0) * (1.0 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1.0 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1.0 - fy) + bot * fy


def albedo_of(scene, paths, stack, address: str = "mirror"):
    """The `albedo(b, idx, kd_b)` of `tracer.replay_radiance` for recorded
    paths (a block of rows of them): the stack sampled at each hit's UV
    where its object's tex_id is >= 0, kd_b elsewhere."""
    def albedo(b, idx, kd_b):
        prim, center, radius, _, height = scene.fields(idx)
        tid = scene.tex_id.index_select(0, idx)
        pos = tuple(paths.pos[b, k] for k in range(3))
        u, v = surface_uv(prim, center, radius, height, pos)
        smp = bilinear(stack, tid.clamp(min=0).to(torch.int64), u, v, address)
        return torch.where((tid >= 0)[:, None], smp, kd_b)

    return albedo


def _rows(p, lo: int, hi: int):
    """The recorded paths of rows lo ... hi - 1."""
    out = tracer.Paths(None, None, None, p.objs[:, lo:hi], p.atten[:, lo:hi], p.sky[lo:hi])
    out.pos = p.pos[:, :, lo:hi]
    return out


def _radiance(scene, p, kd, emission, stack, fault):
    if fault == "no_texture":
        return tracer.replay_radiance(p, kd, emission)
    address = "clamp" if fault == "clamp_taps" else "mirror"
    return tracer.replay_radiance(p, kd, emission, albedo_of(scene, p, stack, address))


def image(scene, paths, kd, emission, stack, fault=None):
    """The mean radiance f[R, 3] over the samples' recorded paths."""
    r = paths[0].objs.shape[1]
    img = torch.zeros((r, 3), dtype=kd.dtype, device=kd.device)
    with torch.no_grad():
        for p in paths:
            for lo in range(0, r, ROWS):
                hi = min(r, lo + ROWS)
                img[lo:hi] += _radiance(scene, _rows(p, lo, hi), kd, emission, stack, fault)
    return img / len(paths)


def loss_and_grads(scene, paths, kd, emission, stack, fault=None):
    """(loss, d/d kd, d/d emission, d/d stack) of `sum(rad^2)`, rad the
    mean radiance over the samples' recorded paths (the pixels of the
    first half only under the `half_batch` fault)."""
    img = image(scene, paths, kd, emission, stack, fault)
    r = img.shape[0]
    keep = r // 2 if fault == "half_batch" else r
    loss = (img[:keep] * img[:keep]).sum()
    cot = 2.0 * img / len(paths)
    grads = [torch.zeros_like(x) for x in (kd, emission, stack)]
    for p in paths:
        for lo in range(0, keep, ROWS):
            hi = min(keep, lo + ROWS)
            leaves = [x.detach().clone().requires_grad_(True) for x in (kd, emission, stack)]
            rad = _radiance(scene, _rows(p, lo, hi), *leaves, fault)
            got = torch.autograd.grad((rad * cot[lo:hi]).sum(), leaves, allow_unused=True)
            for g, x in zip(grads, got):
                if x is not None:
                    g += x
    return loss, *grads
