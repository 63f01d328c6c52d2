"""Interactive fly-camera viewer, terminal edition (counterpart of
``cpppathtracer_tpu/interactive.py``).

The reference's interactivity is a Win32 window with WASDQE translation,
mouse-drag rotation and R to reset accumulation (`cppSrc/main_wnd.cpp`,
`cppSrc/video_renderer.cpp:147-280`).  Here progressive frames are drawn
as 24-bit ANSI half-block cells (two pixels per character):

  w/a/s/d/q/e  translate (normalised diagonal speed, like OnRender)
  i/j/k/l      rotate look-at (the mouse-drag analog)
  -/+          fov zoom (the right-drag analog)
  r            reset accumulation     ESC/Ctrl-C  quit

Keys apply between progressive samples; any motion restarts the
accumulation, as `MotionalCamera::Refresh` does.
"""

from __future__ import annotations

import select
import sys

import numpy as np

from cpppathtracer_tpu_torch.models.camera import Camera
from cpppathtracer_tpu_torch.renderer import ProgressiveRenderer, RenderConfig


def frame_to_ansi(img: np.ndarray) -> str:
    """f32[H,W,3] in [0,1] -> ANSI half-block string (H/2 lines)."""
    h = img.shape[0] - (img.shape[0] % 2)
    rgb = (np.clip(img[:h], 0.0, 1.0) * 255.99).astype(np.uint8)
    top = rgb[0::2]
    bot = rgb[1::2]
    lines = []
    for yt, yb in zip(top, bot):
        parts = []
        for (tr, tg, tb), (br, bg, bb) in zip(yt, yb):
            parts.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


def apply_key(key: str, renderer: ProgressiveRenderer, step_scale: float = 0.05,
              rot_step: float = 0.05) -> bool:
    """Apply one key to the renderer's camera (returns False on quit).
    Translation uses the per-axis move ops; several held directions are
    the caller's concern (fly_path reproduces the normalised-diagonal
    combination of VideoRenderer::OnRender)."""
    c = Camera
    table = {
        "w": (c.move_forward, step_scale),
        "s": (c.move_backward, step_scale),
        "a": (c.move_left, step_scale),
        "d": (c.move_right, step_scale),
        "q": (c.move_up, step_scale),
        "e": (c.move_down, step_scale),
        "i": (c.rotate_up, rot_step),
        "k": (c.rotate_down, rot_step),
        "j": (c.rotate_left, rot_step),
        "l": (c.rotate_right, rot_step),
        "-": (c.scale_fov, -60.0),
        "+": (c.scale_fov, 60.0),
        "=": (c.scale_fov, 60.0),
    }
    if key in ("\x1b", "\x03"):
        return False
    if key == "r":
        renderer.refresh()
        return True
    if key in table:
        fn, arg = table[key]
        renderer.move_camera(fn, arg)
    return True


def run(scene, camera, sky_tex, *, max_depth: int = 6, max_frames: int | None = None,
        key_source=None, out=sys.stdout) -> int:
    """Drive the interactive loop.  `key_source` yields key strings (None =
    the real stdin in cbreak mode); `max_frames` bounds the loop for
    scripting.  Returns the number of frames rendered."""
    cfg = RenderConfig(width=camera.width, height=camera.height, max_depth=max_depth)
    renderer = ProgressiveRenderer(scene, camera, sky_tex, cfg)

    use_tty = key_source is None and sys.stdin.isatty()
    if use_tty:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)

    frames = 0
    try:
        while max_frames is None or frames < max_frames:
            renderer.step()
            img = renderer.frame()
            out.write("\x1b[H\x1b[2J" if use_tty else "")
            out.write(frame_to_ansi(img))
            out.write(
                f"\n\x1b[0mspp {renderer.state.sample_idx}  "
                f"fov {float(renderer.camera.view_fov):.1f}  "
                "[wasdqe move, ijkl rotate, -+ fov, r reset, ESC quit]\n"
            )
            out.flush()
            frames += 1

            keys = []
            if key_source is not None:
                try:
                    keys.append(next(key_source))
                except StopIteration:
                    break
            elif use_tty:
                while select.select([sys.stdin], [], [], 0)[0]:
                    keys.append(sys.stdin.read(1))
            for k in keys:
                if k and not apply_key(k, renderer):
                    return frames
    finally:
        if use_tty:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return frames
