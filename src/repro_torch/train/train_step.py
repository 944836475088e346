"""Train step: loss -> gradients -> AdamW, with microbatch gradient
accumulation and an optional gradient-compression hook.

The step never waits for the device: its step counter stays a 0-dim int32
tensor on the device, and the schedule, the clip and the update are tensor
operations.  Remat comes from the config (``remat="block"`` recomputes
each scan group in the backward; ``Model.forward`` applies it under grad
mode).  A step returns a new ``TrainState`` and leaves the one it was
given as it was; a step made with ``donate=True`` writes the new
parameters and moments into the given state's tensors instead (see
``adamw_update``): that state is spent."""

from __future__ import annotations

from typing import NamedTuple

import torch

from torch.distributed.tensor import DTensor, Replicate

from ..tree import tree_leaves, tree_map
from ..optim.adamw import (AdamWState, adamw_init, adamw_update,
                           cosine_schedule)
from .losses import cross_entropy_loss

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "batch_grads"]

_METRICS = ("loss", "nll", "z_loss", "accuracy", "tokens", "aux_loss")


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: torch.Tensor         # () int32


def init_train_state(model, generator: torch.Generator | None = None,
                     moment_dtype=torch.float32) -> TrainState:
    """Parameters from ``generator`` (``Model.init``'s seed 0 when None),
    zero moments and step 0, on the model's device."""
    params = model.init(generator)
    return TrainState(params, adamw_init(params, moment_dtype),
                      torch.zeros((), dtype=torch.int32, device=model.device))


def _loss_and_grads(model, params, tokens, labels, mask, prefix_embeds,
                    aux_weight):
    """(grads in the parameters' dtypes, detached metrics) of one batch."""
    with torch.enable_grad():
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        kw = {} if prefix_embeds is None else {"prefix_embeds": prefix_embeds}
        logits, aux = model.forward(leaves, tokens, **kw)
        if model.cfg.input_mode == "tokens+prefix":
            logits = logits[:, model.cfg.n_prefix_embeds:]
        loss, metrics = cross_entropy_loss(logits, labels, mask)
        metrics["aux_loss"] = aux
        metrics = {k: _replicated(v) for k, v in metrics.items()}
        flat = tree_leaves(leaves)
        grads = iter(torch.autograd.grad(
            metrics["loss"] + aux_weight * metrics["aux_loss"], flat))
    # under a mesh each gradient comes back in whatever layout the
    # backward left it (a batch-sharded product's weight gradient is a
    # partial sum over dp): the parameter's own placements are the ZeRO
    # reduce-scatter
    return (tree_map(lambda p: _placed_like(next(grads), p), params),
            {k: v.detach() for k, v in metrics.items()})


def _replicated(t):
    """A DTensor scalar made whole on every rank (a partial sum reduced);
    plain tensors as they are.  The backward must start from a
    replicated loss, or each rank's ones would be summed."""
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh,
                              [Replicate()] * t.device_mesh.ndim)
    return t


def _placed_like(g, p):
    if isinstance(g, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def batch_grads(model, params, batch: dict, *, microbatch: int = 0,
                aux_weight: float = 1.0, accum_dtype=torch.float32):
    """(grads, metrics) of ``batch`` at ``params``.

    batch: {"tokens": (B, S+1) integer}; inputs are [:, :-1], labels
    [:, 1:]; optional "mask" (B, S) and "prefix_embeds".  ``microbatch``
    > 0 (and < B) runs ``B // microbatch`` chunks and accumulates
    ``g / n`` in ``accum_dtype``; metrics are the chunks' means, with
    ``tokens`` summed.
    """
    tokens = batch["tokens"][:, :-1]
    labels = batch["tokens"][:, 1:]
    mask = batch.get("mask")
    px = batch.get("prefix_embeds")
    B = tokens.shape[0]
    if not microbatch or microbatch >= B:
        return _loss_and_grads(model, params, tokens, labels, mask, px,
                               aux_weight)
    n = B // microbatch
    # true division on every device (CUDA's division by a Python scalar
    # multiplies by its reciprocal)
    n_t = torch.scalar_tensor(n, dtype=torch.float32, device=tokens.device)
    g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dtype),
                     params)
    m_acc = {k: torch.zeros((), dtype=torch.float32, device=tokens.device)
             for k in _METRICS}
    for i in range(n):
        def sl(x):
            if x is None:
                return None
            part = x[i * microbatch:(i + 1) * microbatch]
            if isinstance(x, DTensor):      # keep the batch's layout
                part = part.redistribute(x.device_mesh, x.placements)
            return part
        grads, metrics = _loss_and_grads(model, params, sl(tokens),
                                         sl(labels), sl(mask), sl(px),
                                         aux_weight)
        g_acc = tree_map(lambda a, g: a + g.to(accum_dtype) / n_t, g_acc,
                         grads)
        del grads
        m_acc = {k: m_acc[k] + metrics[k] / n_t for k in _METRICS}
    m_acc["tokens"] = m_acc["tokens"] * n           # summed, not meaned
    return g_acc, m_acc


def make_train_step(model, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, weight_decay: float = 0.1,
                    microbatch: int = 0, aux_weight: float = 1.0,
                    compress_grads=None, accum_dtype=torch.float32,
                    donate: bool = False):
    """Returns ``train_step(state, batch) -> (state', metrics)``.

    ``compress_grads``: optional fn(grads) -> grads between accumulation
    and the optimizer (``distributed.compression.make_compressor``).  The
    learning rate is ``cosine_schedule(state.step)``.  ``donate``: state'
    holds ``state``'s parameter and moment tensors, updated in place (the
    step counters are new 0-dim tensors); ``state`` is spent.
    """

    def train_step(state: TrainState, batch: dict):
        grads, metrics = batch_grads(model, state.params, batch,
                                     microbatch=microbatch,
                                     aux_weight=aux_weight,
                                     accum_dtype=accum_dtype)
        if compress_grads is not None:
            grads = compress_grads(grads)
        lr = cosine_schedule(state.step, peak_lr, warmup, total_steps)
        params, opt, om = adamw_update(state.params, grads, state.opt, lr,
                                       weight_decay=weight_decay,
                                       donate=donate)
        metrics.update(om)
        metrics["lr"] = lr
        return TrainState(params, opt, state.step + 1), metrics

    return train_step
