"""`demo_scene(0)` with albedo textures, as the port's
`chip_smoke.py::textured_scene` builds it (neither the JAX package nor the
C++ reference ships a textured scene), frozen here so that the yardstick
does not move with the program.

scene(seed): the frozen `demo_scene(seed)` (`reference/scenes.py`) with
texture 0 on the platform, texture 1 on every cylinder and none on the
spheres.  textures(size, cell, sky_seed): two textures of size x size
texels, a checker of cell x cell squares, (0.9, 0.8, 0.3) on the odd
squares and (0.2, 0.3, 0.7) on the even ones, and the frozen
`procedural_sky(size, size, sky_seed)`.  Nothing of the program is
imported.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import scenes

ODD, EVEN = (0.9, 0.8, 0.3), (0.2, 0.3, 0.7)


def scene(seed: int = 0) -> dict:
    a = scenes.demo_scene(seed)
    pt = a["prim_type"]
    a["tex_id"] = np.where(pt == scenes.PLATFORM, 0,
                           np.where(pt == scenes.CYLINDER, 1, -1)).astype(np.int32)
    return a


def textures(size: int = 256, cell: int = 32, sky_seed: int = 1) -> np.ndarray:
    squares = (np.arange(size)[:, None] // cell + np.arange(size)[None, :] // cell) % 2
    checker = np.where(squares[..., None] == 1, np.float32(ODD), np.float32(EVEN))
    return np.stack([checker.astype(np.float32),
                     scenes.procedural_sky(size, size, seed=sky_seed)])
