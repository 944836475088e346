"""int8 gradient compression with error feedback.

Each leaf is quantised to int8 against its max-abs scale, as it would be
before a data-parallel reduction (4x fewer bytes than float32, 2x fewer
than bf16 on the wire).  The quantisation residual is carried in an
error-feedback buffer and added back before the next quantisation, so
the compression bias does not accumulate (Seide et al.; Karimireddy et
al.).  On one device this is quantisation noise plus feedback, which is
what the tests check for convergence.  ``compressed_psum`` is the
reduction itself over a mesh axis or a process group: int8-range codes
summed in int32 against the axis's largest scale.
"""

from __future__ import annotations

import torch

from ..tree import tree_map, tree_unzip
from .collectives import pmax, psum

__all__ = ["CompressionState", "init_compression", "compress_leaf",
           "decompress_leaf", "compressed_psum", "make_compressor"]

CompressionState = dict     # alias: the error-feedback tree


def init_compression(params) -> dict:
    """Error-feedback buffers (float32), zero, shaped as ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_leaf(g: torch.Tensor):
    """(int8 q, float32 scale): symmetric max-abs quantisation.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    gf = g.float()
    # divisions by 0-dim tensors: IEEE division on every device
    scale = gf.abs().max() / torch.scalar_tensor(
        127.0, dtype=torch.float32, device=gf.device) + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, axis) -> torch.Tensor:
    """The mean of ``g`` over ``axis`` (``(mesh, name)`` or a process
    group) through int8-range codes: quantise against the axis's largest
    max-abs scale, sum the codes in int32, dequantise and divide by the
    axis size (the reference's all-reduce-compatible scheme: value =
    sum q_i * s / n).  At one rank it is ``decompress_leaf(
    *compress_leaf(g))``'s arithmetic."""
    gf = g.float()
    scale = pmax(gf.abs().max(), axis) / torch.scalar_tensor(
        127.0, dtype=torch.float32, device=gf.device) + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
    total = psum(q, axis)
    n = psum(torch.ones((), dtype=torch.float32, device=gf.device), axis)
    return total.float() * scale / n


def make_compressor(error_feedback: dict | None = None):
    """Returns ``(compress(grads) -> grads, feedback_getter)``.

    Quantisation noise is injected where the wire compression would be,
    with error feedback; the decompressed gradients keep their dtypes.
    """
    state = {"ef": error_feedback}

    @torch.no_grad()
    def compress(grads):
        ef = state["ef"]
        if ef is None:
            ef = init_compression(grads)

        def one(g, e):
            corrected = g.float() + e
            deq = decompress_leaf(*compress_leaf(corrected))
            return deq.to(g.dtype), corrected - deq

        deq, state["ef"] = tree_unzip(tree_map(one, grads, ef), 2)
        return deq

    return compress, lambda: state["ef"]
