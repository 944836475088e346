"""Serving steps: batched prefill + single-token decode (+ greedy/sampled
generation loop and cascade early-exit serving).

``serve_step`` for the dry-run shapes is the **decode** step: one new
token against a KV/recurrent cache of the shape's length.  Every step and
``generate`` run under ``torch.no_grad()``: parameters fresh from training
(which require grad) serve as their detached copies would, and no output
requires grad.

A step made with ``donate=True`` writes the new cache into the tensors of
the cache it is given and returns them (the reference's dry run donates
the cache to its jitted step).  The caller gives that cache up: JAX
raises on a donated buffer's later use, the port cannot, and the old
cache's tensors simply hold the new entries.  The default returns a new
cache and leaves the old one as it was."""

from __future__ import annotations

import torch

from ..models.early_exit import decode_step_cascade
from ..train.losses import vocab_argmax

__all__ = ["make_prefill_step", "make_decode_step", "generate",
           "make_cascade_decode_step"]


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last position's float32 logits (the first maximum,
    as ``jnp.argmax``), as int32; vocabulary-sharded DTensor logits are
    reduced over their shards."""
    return vocab_argmax(logits[:, -1].float()).to(torch.int32)


def make_prefill_step(model, *, donate: bool = False):
    """``prefill_step(params, tokens, cache, prefix_embeds=None) ->
    (logits, cache)``; ``donate``: ``cache`` is written in place."""
    @torch.no_grad()
    def prefill_step(params, tokens, cache, prefix_embeds=None):
        return model.prefill(params, tokens, cache,
                             prefix_embeds=prefix_embeds, donate=donate)
    return prefill_step


def make_decode_step(model, *, sample: bool = False, donate: bool = False):
    """``decode_step(params, token, cache, rng=None) -> (next, cache,
    logits)``; sampling draws from ``rng``, a ``torch.Generator`` on the
    model's device; ``donate``: ``cache`` is written in place."""
    @torch.no_grad()
    def decode_step(params, token, cache, rng=None):
        logits, cache = model.decode_step(params, token, cache,
                                          donate=donate)
        if sample:
            probs = torch.softmax(logits[:, -1].float(), -1)
            nxt = torch.multinomial(probs, 1, generator=rng)[:, 0].to(
                torch.int32)
        else:
            nxt = _greedy(logits)
        return nxt, cache, logits
    return decode_step


def make_cascade_decode_step(model, ecfg, *, donate: bool = False):
    """Early-exit (paper-cascade) decode step; returns exit depths too.
    ``donate``: ``cache`` is written in place."""
    @torch.no_grad()
    def decode_step(params, token, cache):
        logits, cache, depth = decode_step_cascade(model, params, token,
                                                   cache, ecfg, donate)
        return _greedy(logits), cache, depth
    return decode_step


@torch.no_grad()
def generate(model, params, prompt_tokens, max_new: int = 32,
             max_len: int | None = None, prefix_embeds=None,
             sample: bool = False, seed: int = 0):
    """Host-loop generation: prefill, then ``max_new - 1`` decode steps.
    Returns (B, max_new) int32 tokens (the first from the prefill's
    logits, greedy).  Sampling draws from a ``torch.Generator`` seeded
    with ``seed`` on the model's device."""
    B, S = prompt_tokens.shape
    max_len = max_len or (S + max_new)
    cache = model.init_cache(B, max_len)
    decode = make_decode_step(model, sample=sample)
    logits, cache = make_prefill_step(model)(params, prompt_tokens, cache,
                                             prefix_embeds)
    token = _greedy(logits)
    out = [token]
    rng = torch.Generator(device=model.device).manual_seed(seed)
    for _ in range(max_new - 1):
        token, cache, _ = decode(params, token, cache, rng=rng)
        out.append(token)
    return torch.stack(out, 1)
