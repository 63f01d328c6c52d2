"""PyTorch / CUDA port of cpppathtracer_tpu for NVIDIA Hopper.

The JAX package ``cpppathtracer_tpu`` is the reference; this package
imports nothing of it and no JAX.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``, which runs the plain PyTorch versions
of the kernels.
"""
