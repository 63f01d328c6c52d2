"""The cell's inputs, made by the benchmark and handed to both sides.

The scene, camera and sky come from the configuration through the frozen
generators of `benchmark/reference/scenes.py`.  The program builds its own
objects from those arrays through its public constructors (and derives its
BVH tables itself); the reference builds its own from the same arrays.
Random draws of the traffic come from `rng(ctx, stream)`, a function of the
seed alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference import scenes, tracer


def seed_words(seed: int) -> list:
    """A seed of any size as 32-bit words (its value modulo 2^64)."""
    v = int(seed) % (1 << 64)
    return [v & 0xFFFFFFFF, v >> 32]


def seed_word(seed: int) -> int:
    """A seed as the program's 32-bit seed word (its value modulo 2^32)."""
    return int(seed) & 0xFFFFFFFF


def rng(ctx, stream: int) -> np.random.Generator:
    """The traffic's random stream `stream`, drawn from the seed."""
    return np.random.default_rng(seed_words(ctx.seed) + [int(stream)])


@functools.lru_cache(maxsize=4)
def _arrays(scene_key: str, sky_key: str):
    import json

    spec, sky = json.loads(scene_key), json.loads(sky_key)
    return scenes.make_scene(spec), scenes.procedural_sky(**sky)


def arrays(ctx):
    """(scene arrays, sky f32[H, W, 3]) of the cell's configuration."""
    import json

    cfg = ctx.config
    return _arrays(json.dumps(cfg["scene"], sort_keys=True), json.dumps(cfg["sky"], sort_keys=True))


def camera_spec(ctx):
    return scenes.make_camera(ctx.config["camera"])


def program_inputs(ctx):
    """The program's scene (with BVH tables where the configuration asks
    for them), camera and sky on the cell's first device."""
    from cpppathtracer_tpu_torch import convert
    from cpppathtracer_tpu_torch.models.camera import Camera

    arr, sky = arrays(ctx)
    perm, counts = scenes.type_partition(arr["prim_type"])
    dev = ctx.device
    scene = convert.scene_from_numpy(arr, perm, counts, device=dev)
    if ctx.config.get("bvh"):
        scene = scene.with_bvh(ctx.config.get("leaf_size"))
    cam = camera_spec(ctx)
    s = ctx.settings
    camera = Camera.make(s["width"], s["height"], origin=cam["origin"], look_at=cam["look_at"],
                         view_fov=cam["view_fov"], device=dev)
    return {"scene": scene, "camera": camera, "sky": convert.sky_from_numpy(sky, device=dev)}


def reference_inputs(ctx, dtype, pose=None):
    """The reference's scene, camera (at `pose`, (origin, look_at, fov),
    when given) and sky in `dtype` on the cell's first device."""
    arr, sky = arrays(ctx)
    cam = camera_spec(ctx)
    origin, look_at, fov = pose or (cam["origin"], cam["look_at"], cam["view_fov"])
    s = ctx.settings
    dev = ctx.device
    return {"scene": tracer.Scene(arr, dev, dtype, ctx.config.get("search", "direct")),
            "camera": tracer.Camera(origin, look_at, fov, s["width"], s["height"], dev, dtype),
            "sky": torch.as_tensor(sky, device=dev).to(dtype)}
