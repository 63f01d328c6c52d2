"""Benchmark of the PyTorch/CUDA port: rays/s forward+backward at
1024x1024 x 64 spp x depth 8 on the CUDA card, one JSON line on stdout
(counterpart of bench.py; ``--device cpu`` runs the CPU smoke size).

    python bench_torch.py [--device cpu]
"""

from cpppathtracer_tpu_torch.bench import main

if __name__ == "__main__":
    main()
