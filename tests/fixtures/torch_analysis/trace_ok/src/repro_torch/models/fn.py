"""Clean twin: the Function's forward branches on its static argument."""

import torch


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, flag):
        if flag:
            x = x * 2
        return x

    @staticmethod
    def backward(ctx, g):
        return g * 2, None
