"""The plain reference of the inverse-rendering step: the L2 loss of a
render against a target over kd and emission, its gradients, and Adam
(optax.adam's update: betas 0.9 / 0.999, eps 1e-8 outside the root).

A path's geometry does not depend on kd or emission, so each sample's paths
are traced once (`tracer.trace(record=True)`) and its radiance is the
recurrence `tracer.replay_radiance` over the two fields: the loss's
gradient is the sum over samples of that recurrence's vector-Jacobian
product with the loss's cotangent.
"""

from __future__ import annotations

import torch

from benchmark.reference import tracer

B1, B2, EPS = 0.9, 0.999, 1e-8


def trace_samples(scene, camera, sky, pix, seed: int, spp: int, depth: int, offset: int):
    """The recorded paths of every pixel, one `Paths` a sample (keys offset
    ... offset + spp - 1), and the live ray-bounces traced."""
    out, live = [], 0
    for s in range(spp):
        samp = torch.full_like(pix, offset + s)
        p = tracer.trace(scene, camera, sky, pix, samp, seed, depth, record=True)
        p.rad = p.first_n = p.first_t = None
        live += p.live_ray_bounces
        out.append(p)
    return out, live


def image(paths, kd, emission):
    """The mean radiance over the samples' recorded paths."""
    acc = None
    for p in paths:
        r = tracer.replay_radiance(p, kd, emission)
        acc = r if acc is None else acc + r
    return acc / len(paths)


def loss_and_grads(paths, kd, emission, target, keep=None):
    """(loss, d loss / d kd, d loss / d emission) of mean((image - target)^2)
    over the pixels (all, or the rows `keep`)."""
    with torch.no_grad():
        img = image(paths, kd, emission)
        diff = img - target if keep is None else (img - target)[keep]
        loss = torch.mean(diff * diff)
        cot = 2.0 * (img - target) / diff.numel() / len(paths)
        if keep is not None:
            mask = torch.zeros_like(cot[:, 0])
            mask[keep] = 1.0
            cot = cot * mask[:, None]
    g_kd = torch.zeros_like(kd)
    g_em = torch.zeros_like(emission)
    for p in paths:
        k = kd.detach().clone().requires_grad_(True)
        e = emission.detach().clone().requires_grad_(True)
        r = tracer.replay_radiance(p, k, e)
        gk, ge = torch.autograd.grad((r * cot).sum(), [k, e])
        g_kd += gk
        g_em += ge
    return loss, g_kd, g_em


class Adam:
    """optax.adam on a list of tensors."""

    def __init__(self, params, lr: float):
        self.lr = lr
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params, grads):
        self.count += 1
        bc1, bc2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1.0 - B1) * g + B1 * self.mu[i]
            self.nu[i] = (1.0 - B2) * (g * g) + B2 * self.nu[i]
            out.append(p - self.lr * ((self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + EPS)))
        return out
