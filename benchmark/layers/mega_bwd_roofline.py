"""mega_bwd_roofline: kernel #8's share of its roofline
(`roofline/mega_bwd.py`) over its device time in the traced window, in %;
nothing where #8 did not run."""


def read(view):
    t = view.kernel_s("mega_bwd_kernel")
    if t <= 0:
        return None
    work = view.counted_work()
    return 100.0 * view.roofline("mega_bwd").bound_s(work, view.config["objects"], view.peaks) / t
