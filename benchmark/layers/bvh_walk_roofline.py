"""bvh_walk_roofline: kernel #7's share of its roofline
(`roofline/bvh_walk.py`: the slab tests and leaf rows the live rays need of
the walk) over its device time in the traced window, in %; nothing where
#7 did not run."""


def read(view):
    t = view.kernel_s("bvh_winner_kernel")
    if t <= 0:
        return None
    work = view.counted_work()
    return 100.0 * view.roofline("bvh_walk").bound_s(work, view.config["objects"], view.peaks) / t
