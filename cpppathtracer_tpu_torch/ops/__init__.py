"""Part of the PyTorch/CUDA port (see the package docstring)."""
