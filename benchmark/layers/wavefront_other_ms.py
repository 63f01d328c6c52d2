"""wavefront_other_ms: device milliseconds a sample outside the port's
hand-written kernels (the wavefront body's PyTorch operations around the
walk), over the traced window's samples."""


def read(view):
    samples = view.work.get("samples", 0)
    if samples <= 0 or view.busy_s <= 0:
        return None
    return 1e3 * (view.busy_all_s() - view.hand_written_s()) / samples
