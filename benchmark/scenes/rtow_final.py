"""The final render of "Ray Tracing in One Weekend" (P. Shirley, T. D. Black,
S. Hollasch; raytracing.github.io, book 1, v3.2.3, section 13.1 "A Final
Render": `random_scene()` and `main()`), as the benchmark's own frozen
copy: the scene in `reference/scenes.py`'s FIELDS layout and the book's
sky as a map for the sky lookup.  Nothing of the program is imported, so
no later change to it can move these inputs.

The book's materials on the four BSDFs both sides trace: diffuse (80% of
the small spheres) as diffuse with kd the albedo; metal (15%) as metal with
kd the albedo and smoothness min(1, ln(2 / fuzz^2) / ln 1000), a Phong
exponent of 2 / fuzz^2 (fuzz 0 gives 1); glass (5%) as glass of ior 1.5,
kd 1, smoothness 1 (its lobe's exponent 1000).  The book's random_double()
is unseeded: the draws here come from `np.random.default_rng(seed)`, in
the book's order.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.scenes import DIFFUSE, GLASS, METAL, Objects

SKY_TOP = (0.5, 0.7, 1.0)


def metal_smoothness(fuzz: float) -> float:
    return 1.0 if fuzz <= 0.0 else min(1.0, math.log(2.0 / (fuzz * fuzz)) / math.log(1000.0))


def scene(seed: int = 0, half: int = 11) -> dict:
    """The ground sphere (radius 1000 at (0, -1000, 0), albedo 0.5), a
    small sphere of radius 0.2 at (a + 0.9 r, 0.2, b + 0.9 r) for a, b in
    -half ... half - 1 unless within 0.9 of (4, 0.2, 0), then glass, diffuse
    (0.4, 0.2, 0.1) and metal (0.7, 0.6, 0.5) of fuzz 0, of radius 1, at
    x = 0, -4, 4."""
    rng = np.random.default_rng(seed)
    rnd = lambda: float(rng.random())
    glass = dict(mat_type=GLASS, kd=(1.0, 1.0, 1.0), smoothness=1.0, ior=1.5)

    def metal(albedo, fuzz):
        return dict(mat_type=METAL, kd=albedo, smoothness=metal_smoothness(fuzz))

    b = Objects()
    b.sphere((0.0, -1000.0, 0.0), 1000.0, mat_type=DIFFUSE, kd=(0.5, 0.5, 0.5))
    for a in range(-half, half):
        for bz in range(-half, half):
            choose = rnd()
            center = (a + 0.9 * rnd(), 0.2, bz + 0.9 * rnd())
            if math.dist(center, (4.0, 0.2, 0.0)) <= 0.9:
                continue
            if choose < 0.8:
                c1 = (rnd(), rnd(), rnd())
                c2 = (rnd(), rnd(), rnd())
                m = dict(mat_type=DIFFUSE, kd=tuple(x * y for x, y in zip(c1, c2)))
            elif choose < 0.95:
                albedo = (0.5 + 0.5 * rnd(), 0.5 + 0.5 * rnd(), 0.5 + 0.5 * rnd())
                m = metal(albedo, 0.5 * rnd())
            else:
                m = glass
            b.sphere(center, 0.2, **m)
    b.sphere((0.0, 1.0, 0.0), 1.0, **glass)
    b.sphere((-4.0, 1.0, 0.0), 1.0, mat_type=DIFFUSE, kd=(0.4, 0.2, 0.1))
    b.sphere((4.0, 1.0, 0.0), 1.0, **metal((0.7, 0.6, 0.5), 0.0))
    return b.arrays()


def sky(height: int = 256, width: int = 512) -> np.ndarray:
    """The book's sky, white blended to (0.5, 0.7, 1) by t = 0.5 (1 + dir.y),
    f32[H, W, 3] for the lookup v = asin(dz) / pi + 1/2, u = atan(dy / dx) /
    (2 pi): at each texel centre (u, v) a direction's |y| is cos(pi (v -
    1/2)) |sin(2 pi u)|.  Exact at the texel centres of every upward
    direction; the lookup reads (x, y, z) and (-x, -y, z) at one texel, so
    a downward direction sees its mirror image above the horizon."""
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    u = (np.arange(width, dtype=np.float64) + 0.5) / width
    t = 0.5 * (1.0 + np.cos(np.pi * (v - 0.5))[:, None] * np.abs(np.sin(2.0 * np.pi * u))[None, :])
    top = np.asarray(SKY_TOP, np.float64)
    return ((1.0 - t)[..., None] + t[..., None] * top).astype(np.float32)
