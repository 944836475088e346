"""PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

Mirrors the reference package's layout (``core/``, ``plan/``,
``kernels/``, ``configs/``).  It imports torch and numpy, never jax and
nothing of ``repro``.  The TPU kernels on the detection path are
hand-written CUDA C++ under ``csrc/``, built with nvcc at first use; each
has a plain PyTorch version beside it, which CPU tensors take.
"""
