"""The benchmark of the PyTorch and CUDA port (see benchmark/README.md)."""
