"""texture_taps_ms: device milliseconds a sample in the float32 index-add
kernels, over the traced window's samples: the backward of the texture
taps' `index_select` (`ops/texture.py::sample_bilinear`), an
`index_add_` into each texture.  A record counts where its full name is
an `indexFunc...` kernel whose first template argument is `float`; the
float64 scatter of the textured replay's table gathers is `double` there
and is left out, and so is every other kernel.  The two float32 index-adds
of the step's table build (kd and emission, one row an object) count too,
some microseconds a step.  Nothing in a cell without textures."""

import re

TAPS = re.compile(r"\bindexFunc\w*<\s*float\s*,")


def read(view):
    samples = view.work.get("samples", 0)
    if view.config.get("textures") is None or samples <= 0:
        return None
    t = view.named_s(TAPS.search)
    return 1e3 * t / samples if t > 0 else None
