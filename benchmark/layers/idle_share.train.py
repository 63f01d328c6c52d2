"""idle_share.train: as `idle_share.serve`, in the training cells."""

from benchmark.harness import registry

read = registry.layer_reader("idle_share.serve").read
