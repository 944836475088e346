"""Losses.  The reference takes the label logit with a one-hot einsum, so
that a vocab-sharded (B, S, V) logits tensor reduces to a partial matmul
and a small all-reduce; the port gathers it, which reads the same float32
value and spares a (B, S, V) one-hot.  Logits that are a DTensor (batch
over dp, vocabulary over tp) take the same float32 arithmetic on each
rank's shard, with the vocabulary's max, sum, label logit and argmax and
the batch's sums completed by collectives (``_cross_entropy_mesh``)."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.collectives import axis_index, pmax, psum
from ..distributed.sharding import P, shard_map

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
    if isinstance(logits, DTensor):
        return _cross_entropy_mesh(logits, labels, mask, z_loss)
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
        mask = torch.ones_like(labels, dtype=torch.float32)
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


def _argmax_split(lf, vax):
    """The first index of the largest entry along the last dim, which is
    split in order over ``vax`` (None: whole here)."""
    best, arg = lf.max(-1)
    if not vax:
        return arg
    arg = arg + axis_index(vax) * lf.shape[-1]
    cand = torch.where(best == pmax(best, vax), arg,
                       torch.iinfo(torch.int64).max)
    return -pmax(-cand, vax)


def vocab_argmax(logits):
    """``argmax(-1)`` of DTensor logits (batch and / or vocabulary
    sharded) as a DTensor, reduced over the vocabulary's shards; a plain
    tensor's own argmax."""
    if not isinstance(logits, DTensor):
        return logits.argmax(-1)
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    last = logits.dim() - 1
    batch = tuple(n for n, p in zip(names, logits.placements)
                  if p == Shard(0))
    vocab = tuple(n for n, p in zip(names, logits.placements)
                  if p == Shard(last))
    bdim = (batch if len(batch) != 1 else batch[0]) or None
    vdim = (vocab if len(vocab) != 1 else vocab[0]) or None
    rows = (bdim,) + (None,) * (last - 1)
    vax = (mesh, vocab) if vocab else None
    return shard_map(lambda lf: _argmax_split(lf, vax), mesh,
                     (P(*rows, vdim),), P(*rows))(logits)


def _cross_entropy_mesh(logits, labels, mask, z_loss: float):
    """``cross_entropy_loss`` of DTensor logits whose placements shard the
    batch (dim 0) and / or the vocabulary (the last dim)."""
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    last = logits.dim() - 1
    batch = tuple(n for n, p in zip(names, logits.placements)
                  if p == Shard(0))
    vocab = tuple(n for n, p in zip(names, logits.placements)
                  if p == Shard(last))
    if len(batch) + len(vocab) + sum(
            p == Replicate() for p in logits.placements) != mesh.ndim:
        raise ValueError(f"logits placed {logits.placements}")
    bdim = batch if len(batch) != 1 else batch[0]
    vdim = vocab if len(vocab) != 1 else vocab[0]
    bspec = (bdim or None,)
    lspec = bspec + (None,) * (last - 1) + (vdim or None,)
    rows = bspec + (None,) * (last - 1)
    vax = (mesh, vocab) if vocab else None
    bax = (mesh, batch) if batch else None
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)

    def red(x, axis):
        return psum(x, axis) if axis else x

    def local(lf, lab, msk):
        lf = lf.float()
        m = lf.amax(-1, keepdim=True).detach()
        if vax:
            m = pmax(m, vax)
        log_z = torch.log(red(torch.exp(lf - m).sum(-1), vax)) + m[..., 0]
        lab = lab.long()
        v0 = axis_index(vax) * lf.shape[-1] if vax else 0
        rel = lab - v0
        mine = (rel >= 0) & (rel < lf.shape[-1])
        picked = torch.gather(lf, -1, torch.where(mine, rel, 0)[..., None])
        label_logit = red(torch.where(mine, picked[..., 0], 0.0), vax)
        nll = log_z - label_logit
        zl = z_loss * torch.square(log_z)
        per_tok = nll + zl
        msk = msk.float()
        denom = torch.clamp(red(msk.sum(), bax), min=1.0)
        arg = _argmax_split(lf, vax)
        out = ((per_tok * msk).sum(), (nll * msk).sum(), (zl * msk).sum(),
               ((arg == lab) * msk).sum(), msk.sum())
        loss, nll_, zl_, acc, tok = (red(t, bax) for t in out)
        return loss / denom, nll_ / denom, zl_ / denom, acc / denom, tok

    scalar = P()
    loss, nll, zl, acc, tok = shard_map(
        local, mesh, (P(*lspec), P(*rows), P(*rows)), (scalar,) * 5)(
        logits, labels, mask)
    return loss, {"loss": loss, "nll": nll, "z_loss": zl, "accuracy": acc,
                  "tokens": tok}
