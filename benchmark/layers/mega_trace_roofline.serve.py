"""mega_trace_roofline.serve: kernel #1's share of its roofline (`roofline/mega_trace.py`)
over its device time in the traced window, in %; nothing where #1 did not
run."""


def read(view):
    t = view.kernel_s("mega_trace_kernel")
    if t <= 0:
        return None
    work = view.counted_work()
    return 100.0 * view.roofline("mega_trace").bound_s(work, view.config["objects"], view.peaks) / t
