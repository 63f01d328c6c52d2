"""Minimal image IO (counterpart of ``cpppathtracer_tpu/utils/png.py``):
PNGs written with the standard library's zlib, images read with PIL.  The
bytes written for a uint8 image equal the JAX package's."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def write_png(path, image) -> None:
    """Write uint8 [H,W,3] or [H,W,4] (or f32 in [0,1]) as PNG.  A tensor
    is moved to the host first."""
    img = image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.99).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_image(path) -> np.ndarray:
    """Read an image to f32[H,W,3] in [0,1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
