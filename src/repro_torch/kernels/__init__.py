"""Kernels of the PyTorch port: plain-torch oracles (``ref``),
hand-written Hopper kernels with their wrappers, and the ``ops`` front door."""
