"""Seeded JIT_CACHE fixture: the three patterns of the port's caches."""

import torch

from repro_torch.kernels import native


def sweep(fns, xs):
    out = []
    for g in fns:
        out.append(torch.compile(g)(xs))        # 1: compile in a loop
    return out


def once(x):
    return torch.compile(lambda v: v * 2)(x)    # 2: inline lambda


def launch(x):
    kernel = native.Kernel("k.cu", "k", [])     # 3: a per-call handle
    return kernel(x)
