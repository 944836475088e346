"""Clean twin: the handle and the compiled function are built once, at
the module's top level."""

import torch

from repro_torch.kernels import native

KERNEL = native.Kernel("k.cu", "k", [])


def _double(v):
    return v * 2


DOUBLE = torch.compile(_double)


def launch(x):
    KERNEL(x)
    return DOUBLE(x)
