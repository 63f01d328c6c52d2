"""The cell's inputs, made by the benchmark and handed to both sides.

The scene, camera and sky come from the configuration: the scene through a
frozen generator of `benchmark/reference/scenes.py` or one the
configuration brings as a file of its own (`benchmark/scenes/<generator>.py`,
`registry.scene_part`), the sky likewise (the frozen `procedural_sky` where
the configuration's `sky` names no generator), and, where the configuration
has a `textures` entry, a stack of albedo textures from its file's
`textures(**args)`, each checked against the layout both sides read
(`scenes.check_scene`, `scenes.check_sky`, `scenes.check_textures`); the
camera from its `camera` entry, lens radius included.  The program builds
its own objects from those arrays through its public constructors (and
derives its BVH tables itself); the reference builds its own from the same
arrays.  Random draws of the traffic come from `rng(ctx, stream)`, a
function of the seed alone.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from benchmark.harness import registry
from benchmark.reference import scenes, tracer

FROZEN = "benchmark/reference/scenes.py"


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


def make_scene(spec: dict, textures: int = 0) -> dict:
    """A configuration's `scene` entry ({"generator": name, "args": {...}})
    as checked arrays, its tex_ids within a stack of `textures`."""
    name = spec["generator"]
    fn, where = ((scenes.SCENES[name], FROZEN) if name in scenes.SCENES
                 else registry.scene_part(name, "scene"))
    return scenes.check_scene(fn(**spec.get("args", {})), where, textures)


def make_sky(spec: dict) -> np.ndarray:
    """A configuration's `sky` entry: {"generator": name, "args": {...}},
    or the frozen procedural sky's arguments; as a checked map."""
    if "generator" not in spec:
        return scenes.check_sky(scenes.procedural_sky(**spec), FROZEN)
    fn, where = registry.scene_part(spec["generator"], "sky")
    return scenes.check_sky(fn(**spec.get("args", {})), where)


def make_textures(spec: dict) -> np.ndarray:
    """A configuration's `textures` entry ({"generator": name, "args":
    {...}}) as a checked stack f32[T, H, W, 3]."""
    fn, where = registry.scene_part(spec["generator"], "textures")
    return scenes.check_textures(fn(**spec.get("args", {})), where)


@functools.lru_cache(maxsize=4)
def _arrays(scene_key: str, sky_key: str, tex_key: str):
    tex = None if tex_key == "null" else make_textures(json.loads(tex_key))
    scene = make_scene(json.loads(scene_key), 0 if tex is None else tex.shape[0])
    return scene, make_sky(json.loads(sky_key)), tex


def _key(spec) -> str:
    return json.dumps(spec, sort_keys=True)


def _all(ctx):
    cfg = ctx.config
    return _arrays(_key(cfg["scene"]), _key(cfg["sky"]), _key(cfg.get("textures")))


def arrays(ctx):
    """(scene arrays, sky f32[H, W, 3]) of the cell's configuration."""
    return _all(ctx)[:2]


def textures(ctx):
    """The configuration's texture stack f32[T, H, W, 3], or None where it
    brings none."""
    return _all(ctx)[2]


def camera_spec(ctx):
    return scenes.make_camera(ctx.config["camera"])


def program_inputs(ctx):
    """The program's scene (with BVH tables where the configuration asks
    for them), camera, sky and texture stack (None without one) on the
    cell's first device."""
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
                         view_fov=cam["view_fov"], lens_radius=cam["lens_radius"], device=dev)
    tex = textures(ctx)
    return {"scene": scene, "camera": camera, "sky": convert.sky_from_numpy(sky, device=dev),
            "tex_stack": None if tex is None else convert.tex_stack_from_numpy(tex, device=dev)}


def reference_inputs(ctx, dtype, pose=None):
    """The reference's scene, camera (at `pose`, (origin, look_at, fov,
    lens_radius), when given), sky and texture stack (None without one) in
    `dtype` on the cell's first device."""
    arr, sky = arrays(ctx)
    tex = textures(ctx)
    cam = camera_spec(ctx)
    origin, look_at, fov, lens = pose or (cam["origin"], cam["look_at"], cam["view_fov"],
                                          cam["lens_radius"])
    s = ctx.settings
    dev = ctx.device
    return {"scene": tracer.Scene(arr, dev, dtype, ctx.config.get("search", "direct")),
            "camera": tracer.Camera(origin, look_at, fov, s["width"], s["height"], dev, dtype,
                                    lens_radius=lens),
            "sky": torch.as_tensor(sky, device=dev).to(dtype),
            "tex_stack": None if tex is None else torch.as_tensor(tex, device=dev).to(dtype)}
