"""Losses.  The reference takes the label logit with a one-hot einsum, so
that a vocab-sharded (B, S, V) logits tensor reduces to a partial matmul
and a small all-reduce; on one device the port gathers it, which reads the
same float32 value and spares a (B, S, V) one-hot."""

from __future__ import annotations

import torch

__all__ = ["cross_entropy_loss"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       z_loss: float = 1e-4):
    """logits (B, S, V) any float dtype; labels (B, S) integer.

    Returns (loss, metrics).  Computed in float32; the max is detached
    (the reference's ``stop_gradient``).  ``z_loss`` regularises the
    log-partition (PaLM-style).  ``mask``: 1.0 counts a position; the
    denominator is at least 1.
    """
    lf = logits.float()
    m = lf.amax(-1, keepdim=True).detach()
    sumexp = torch.exp(lf - m).sum(-1)
    log_z = torch.log(sumexp) + m[..., 0]                  # (B, S)
    labels = labels.long()
    label_logit = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = log_z - label_logit
    zl = z_loss * torch.square(log_z)
    per_tok = nll + zl
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=lf.device)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (per_tok * mask).sum() / denom
    metrics = {
        "loss": loss,
        "nll": (nll * mask).sum() / denom,
        "z_loss": (zl * mask).sum() / denom,
        "accuracy": ((lf.argmax(-1) == labels) * mask).sum() / denom,
        "tokens": mask.sum(),
    }
    return loss, metrics
