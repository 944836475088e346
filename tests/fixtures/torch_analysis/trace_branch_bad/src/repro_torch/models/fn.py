"""Seeded TRACE_BRANCH fixture: an autograd Function's forward is a root;
``x`` takes a gradient, ``flag`` does not (so it is static)."""

import torch


class _Clamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, flag):
        if flag:
            x = x * 2
        if x.sum() > 0:                        # 3: host `if` on x
            x = x - 1
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None
