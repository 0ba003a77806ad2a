"""PyTorch/CUDA port of the model plane, for one NVIDIA H100.

A package beside the JAX reference (``repro``) that imports nothing of it
and nothing of JAX.  It mirrors the reference's layout (``configs/``,
``models/``, ``kernels/``, ``launch/``); the TPU kernels on its path are
hand-written CUDA C++ for Hopper under ``csrc/``, built with ``nvcc`` on
first use.  Entry points run on the card unless asked for the CPU.
"""
