"""bvh_walk_roofline.train: kernel #7's share of its roofline over its device
time in the traced window, in %, as `bvh_walk_roofline` reads it, in the
training cells of BVH scenes (the walk of the step's forward), where it
moves `train_Mrays_s`; nothing where `bvh_walk_roofline` reads nothing."""

from benchmark.harness import registry


def read(view):
    return registry.layer_reader("bvh_walk_roofline").read(view)
