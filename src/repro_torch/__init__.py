"""PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

Mirrors the reference package's layout (``core/``, ``plan/``,
``kernels/``, ``configs/``, ``stream/``, ``scheduling/``, ``serve/``,
``models/``).  It imports torch and numpy, never jax and nothing of
``repro``.  The TPU kernels on the detection path are hand-written CUDA
C++ under ``csrc/``, built with nvcc at first use; each has a plain
PyTorch version beside it, which CPU tensors take.  The LM stack
(``models/``, the LM configs in ``configs/``, ``serve/serve_step.py``) has
no TPU kernel: it is plain PyTorch, as the reference's is jnp.
``device.resolve_device`` gives every entry point its device: ``cuda``
unless the caller names one.
"""
