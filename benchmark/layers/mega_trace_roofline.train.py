"""mega_trace_roofline.train: as `mega_trace_roofline.serve`, in the training cells."""

from benchmark.harness import registry

read = registry.layer_reader("mega_trace_roofline.serve").read
