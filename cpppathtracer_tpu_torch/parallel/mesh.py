"""The pixel-tile device mesh (counterpart of
``cpppathtracer_tpu/parallel/mesh.py``).

The image's rows are split over the mesh's "ty" axis and its columns over
"tx"; the scene, camera and sky are copied to every device (they are
O(objects) and every tile needs all of them), and rays never cross tiles,
so the forward render needs no communication.  One process drives every
device of its mesh.  A device may stand in the mesh more than once (a
virtual mesh): eight tiles then run one after another on one card or on
the CPU, which is how the tests hold an 8-tile render against the
unsharded one.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cpppathtracer_tpu_torch.types import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class TileMesh:
    """A [ty, tx] grid of torch devices with the axis names ("ty", "tx")."""

    devices: np.ndarray  # object[ty, tx] of torch.device
    axis_names: tuple = ("ty", "tx")

    @property
    def shape(self) -> tuple[int, int]:
        return self.devices.shape

    def tiles(self):
        """(ty index, tx index, device) of every tile, row-major."""
        ty, tx = self.shape
        return [(i, j, self.devices[i, j]) for i in range(ty) for j in range(tx)]

    def distinct_devices(self) -> list[torch.device]:
        """The devices of the mesh, each once, in tile order."""
        return list(dict.fromkeys(self.devices.flat))

    @property
    def first_device(self) -> torch.device:
        """Where the frame is assembled and the parameters live."""
        return self.devices[0, 0]


def visible_cards() -> list[torch.device]:
    """Every visible CUDA card; raises without one."""
    resolve_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_tile_mesh(devices=None, shape: tuple[int, int] | None = None) -> TileMesh:
    """A ("ty", "tx") mesh over the given devices (torch devices or their
    names), by default every visible CUDA card (raising without one).

    With no explicit shape it takes the most-square factorisation of the
    device count, so both image axes are split."""
    devices = [torch.device(d) for d in (visible_cards() if devices is None else devices)]
    n = len(devices)
    if shape is None:
        ty = int(math.isqrt(n))
        while n % ty != 0:
            ty -= 1
        shape = (ty, n // ty)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return TileMesh(arr.reshape(shape))


def pad_to_tiles(h: int, w: int, mesh: TileMesh) -> tuple[int, int]:
    """Image dims rounded up so they divide evenly over the mesh (the
    renderer crops the pad off afterwards)."""
    ty, tx = mesh.shape
    return (-(-h // ty) * ty, -(-w // tx) * tx)
