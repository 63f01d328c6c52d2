"""Command line of the PyTorch/CUDA port (counterpart of
``cpppathtracer_tpu/__main__.py``), on the CUDA card unless --device says
otherwise:

  python -m cpppathtracer_tpu_torch render  --preset cornell --out out.png
  python -m cpppathtracer_tpu_torch render  --preset rtow_final   (its own sky and lens)
  python -m cpppathtracer_tpu_torch video   --preset material_zoo --frames 24 --out-dir frames/
  python -m cpppathtracer_tpu_torch invert  --steps 100 --out-dir inverse_out/
  python -m cpppathtracer_tpu_torch progressive --preset demo --frames 16 --out out.png
  python -m cpppathtracer_tpu_torch interactive --preset demo
  python -m cpppathtracer_tpu_torch bench   (same as bench_torch.py; one JSON line on stdout)
  python -m cpppathtracer_tpu_torch render --device cpu ...   (the plain versions on the CPU)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from cpppathtracer_tpu_torch.types import resolve_device


def _load_sky(path, device):
    """The sky texture on `device`: the given image, else the repository's
    assets/sky.png, else (where that file is missing) a procedural sky."""
    from cpppathtracer_tpu_torch.ops.texture import load_texture, procedural_sky

    if not path:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "sky.png"
        )
        if not os.path.exists(path):
            return torch.from_numpy(procedural_sky(512, 512)).to(device)
    return torch.from_numpy(load_texture(path)).to(device)


def _scene_camera(args):
    from cpppathtracer_tpu_torch.models.presets import PRESETS

    preset = PRESETS[args.preset]
    dev = resolve_device(args.device)
    scene, camera = preset.build(device=dev)
    if getattr(args, "size", None):
        w, h = map(int, args.size.split("x"))
        camera = camera.resize(w, h)
    # --sky wins over a preset's own sky
    sky = (preset.sky_fn(device=dev) if preset.sky_fn is not None and not args.sky
           else _load_sky(args.sky, dev))
    return preset, scene, camera, sky


def cmd_render(args):
    from cpppathtracer_tpu_torch.integrator import render_radiance_jit
    from cpppathtracer_tpu_torch.ops.cuda.denoise_kernel import denoise
    from cpppathtracer_tpu_torch.renderer import to_rgb8
    from cpppathtracer_tpu_torch.utils.obs import RaysPerSecond, Timer, get_logger
    from cpppathtracer_tpu_torch.utils.png import write_png

    log = get_logger()
    preset, scene, camera, sky = _scene_camera(args)
    spp = args.spp or preset.spp
    depth = args.depth or preset.max_depth

    meter = RaysPerSecond()
    timing = {}
    h, w = camera.height, camera.width
    with torch.no_grad(), Timer.phase("render", timing) as ph:
        # compiled, as the JAX command jits its render (CUDA graphs on the card)
        rad, n0, d0 = render_radiance_jit(scene, camera, sky, spp=spp, max_depth=depth,
                                          seed=args.seed)
        rad = rad.reshape(h, w, 3)
        if not args.no_denoise:
            rad = denoise(rad, n0.reshape(h, w, 3), d0.reshape(h, w))
        ph["result"] = rad
    meter.add(w, h, spp, depth, timing["render"])
    log.info(
        "rendered %s %dx%d x%dspp depth %d on %s in %.3fs (%.1f Mrays/s incl. kernel build)",
        args.preset, w, h, spp, depth, scene.device, timing["render"], meter.rays_per_sec / 1e6,
    )
    write_png(args.out, to_rgb8(rad))
    log.info("wrote %s", args.out)


def cmd_progressive(args):
    from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig, to_rgb8
    from cpppathtracer_tpu_torch.utils.obs import get_logger
    from cpppathtracer_tpu_torch.utils.png import write_png

    log = get_logger()
    preset, scene, camera, sky = _scene_camera(args)
    cfg = RenderConfig(
        width=camera.width, height=camera.height,
        max_depth=args.depth or preset.max_depth, seed=args.seed,
    )
    r = ProgressiveRenderer(scene, camera, sky, cfg)
    t0 = time.perf_counter()
    for _ in range(args.frames):
        r.step()
    frame = r.frame()  # waits for the device
    dt = time.perf_counter() - t0
    log.info("progressive %d frames in %.3fs (%.3f ms/frame)", args.frames, dt,
             dt * 1e3 / max(args.frames, 1))
    write_png(args.out, to_rgb8(frame))
    log.info("wrote %s", args.out)


def cmd_video(args):
    from cpppathtracer_tpu_torch.utils.obs import get_logger
    from cpppathtracer_tpu_torch.video import orbit_path, render_video

    log = get_logger()
    preset, scene, camera, sky = _scene_camera(args)
    t0 = time.perf_counter()
    frames = render_video(
        scene, orbit_path(camera, args.frames), sky, args.out_dir,
        spp=args.spp or preset.spp, max_depth=args.depth or preset.max_depth, seed=args.seed,
    )
    dt = time.perf_counter() - t0
    log.info("wrote %d frames to %s in %.3fs (%.3f ms/frame)", len(frames), args.out_dir, dt,
             dt * 1e3 / max(len(frames), 1))


def cmd_invert(args):
    from cpppathtracer_tpu_torch.integrator import render_radiance
    from cpppathtracer_tpu_torch.inverse import InverseConfig, fit
    from cpppathtracer_tpu_torch.renderer import to_rgb8
    from cpppathtracer_tpu_torch.utils.obs import MetricsLog, get_logger
    from cpppathtracer_tpu_torch.utils.png import write_png

    log = get_logger()
    _, scene_true, camera, sky = _scene_camera(args)
    camera = camera.resize(args.res, args.res)
    cfg = InverseConfig(spp=args.spp, max_depth=args.depth, fields=("kd",), learning_rate=args.lr,
                        fixed_samples=not args.fresh_samples)
    log.info("rendering target...")
    with torch.no_grad():
        target, _, _ = render_radiance(
            scene_true, camera, sky, spp=cfg.spp, max_depth=cfg.max_depth, seed=0
        )
    rng = np.random.RandomState(1)
    kd0 = scene_true.kd.cpu().numpy().copy()
    kd0 = np.clip(kd0 + rng.uniform(-0.3, 0.3, kd0.shape), 0.05, 1.0).astype(np.float32)
    scene0 = dataclasses.replace(scene_true, kd=torch.from_numpy(kd0).to(scene_true.device))

    metrics = MetricsLog(f"{args.out_dir}/metrics.jsonl")

    def cb(step, loss, params):
        if step % 10 == 0:
            log.info("step %d loss %.3e", step, loss)
        metrics.log(step=step, loss=loss)

    os.makedirs(args.out_dir, exist_ok=True)
    fitted, losses = fit(scene0, camera, sky, target, cfg, steps=args.steps, callback=cb)
    if losses:
        log.info("loss %.3e -> %.3e", losses[0], losses[-1])
    with torch.no_grad():
        final, _, _ = render_radiance(
            fitted, camera, sky, spp=cfg.spp, max_depth=cfg.max_depth, seed=0
        )
    h, w = camera.height, camera.width
    write_png(f"{args.out_dir}/target.png", to_rgb8(target.reshape(h, w, 3)))
    write_png(f"{args.out_dir}/fitted.png", to_rgb8(final.reshape(h, w, 3)))
    log.info("wrote %s/{target,fitted}.png", args.out_dir)


def cmd_interactive(args):
    from cpppathtracer_tpu_torch.interactive import run

    _, scene, camera, sky = _scene_camera(args)
    if not args.size:
        camera = camera.resize(128, 72)
    run(scene, camera, sky, max_depth=args.depth or 6, max_frames=args.frames)


def cmd_bench(args):
    from cpppathtracer_tpu_torch.bench import main as bench_main

    bench_main([] if args.device is None else ["--device", args.device])


def _size_arg(value: str) -> str:
    try:
        w, h = value.split("x")
        int(w), int(h)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected WxH (e.g. 640x480), got {value!r}")
    return value


def main(argv=None):
    from cpppathtracer_tpu_torch.models.presets import PRESETS

    p = argparse.ArgumentParser(prog="cpppathtracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")

    def common(sp):
        sp.add_argument("--preset", default="cornell", choices=sorted(PRESETS))
        sp.add_argument("--size", default=None, type=_size_arg, help="WxH override")
        sp.add_argument("--sky", default=None, help="path to sky image (PNG)")
        sp.add_argument("--spp", type=int, default=None)
        sp.add_argument("--depth", type=int, default=None)
        sp.add_argument("--seed", type=int, default=0)
        device(sp)

    sp = sub.add_parser("render")
    common(sp)
    sp.add_argument("--out", default="render.png")
    sp.add_argument("--no-denoise", action="store_true")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("progressive")
    common(sp)
    sp.add_argument("--frames", type=int, default=16)
    sp.add_argument("--out", default="progressive.png")
    sp.set_defaults(fn=cmd_progressive)

    sp = sub.add_parser("video")
    common(sp)
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--out-dir", default="frames")
    sp.set_defaults(fn=cmd_video)

    sp = sub.add_parser("invert")
    sp.add_argument("--preset", default="material_zoo")
    sp.add_argument("--sky", default=None)
    sp.add_argument("--res", type=int, default=128)
    sp.add_argument("--spp", type=int, default=4)
    sp.add_argument("--depth", type=int, default=4)
    sp.add_argument("--lr", type=float, default=0.05)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--fresh-samples", action="store_true",
                    help="decorrelate MC samples per step (noisier loss)")
    sp.add_argument("--out-dir", default="inverse_out")
    device(sp)
    sp.set_defaults(fn=cmd_invert)

    sp = sub.add_parser("interactive")
    common(sp)
    sp.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: run until ESC)")
    sp.set_defaults(fn=cmd_interactive)

    sp = sub.add_parser("bench")
    device(sp)
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
