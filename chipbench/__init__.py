"""A benchmark of the PyTorch and CUDA port (src/repro_torch) on one H100: see README.md."""
