"""The benchmark of cpppathtracer_tpu_torch: see BENCHMARK.json and PERF.md."""
