"""GQA attention block (dense / local-window) with KV-cache decode."""

from __future__ import annotations

import torch

from .layers import (ParamRng, init_dense, dense, apply_rope,
                     flash_attention, decode_attention)

__all__ = ["init_attn", "attn_block", "init_attn_cache"]


def init_attn(rng: ParamRng, cfg, dtype) -> dict:
    D, Hq, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.head_dim_
    return {
        "wq": init_dense(rng, D, Hq * Dh, dtype, bias=cfg.qkv_bias),
        "wk": init_dense(rng, D, Hkv * Dh, dtype, bias=cfg.qkv_bias),
        "wv": init_dense(rng, D, Hkv * Dh, dtype, bias=cfg.qkv_bias),
        "wo": init_dense(rng, Hq * Dh, D, dtype, scale=(Hq * Dh) ** -0.5),
    }


def attn_block(p: dict, x: torch.Tensor, cfg, *, window: int | None = None,
               cache: dict | None = None, cache_len=None,
               positions: torch.Tensor | None = None):
    """x: (B, S, D).  Returns (out, new_cache).

    - forward:  cache None                      -> flash attention
    - prefill:  cache dict (zeroed)             -> flash + cache write
    - decode:   cache dict, S == 1, cache_len   -> cached attention
      (the new K/V is written at slot ``cache_len % Smax``: a ring buffer
      for windowed layers, a linear buffer otherwise)

    ``cache_len`` is a 0-dim integer tensor on the device.  The input
    cache is not written; the new cache is a copy.
    """
    B, S, D = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    decode = cache is not None and S == 1 and cache_len is not None

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
        if decode:
            positions = positions + cache_len.reshape(-1, 1)
    q = dense(p["wq"], x).reshape(B, S, Hq, Dh)
    k = dense(p["wk"], x).reshape(B, S, Hkv, Dh)
    v = dense(p["wv"], x).reshape(B, S, Hkv, Dh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_frac)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_frac)

    if decode:
        Smax = cache["k"].shape[1]
        slot = cache_len % Smax
        kc = _write_slot(cache["k"], k, slot)
        vc = _write_slot(cache["v"], v, slot)
        # ring buffers hold only in-window entries: every written slot valid
        n_valid = torch.clamp(cache_len + 1, max=Smax)
        o = decode_attention(q, kc, vc, n_valid)
        new_cache = {"k": kc, "v": vc}
    else:
        o = flash_attention(q, k, v, True, window, cfg.attn_chunk_q,
                            cfg.attn_chunk_kv)
        new_cache = None
        if cache is not None:    # prefill: persist the (window-)cache
            Smax = cache["k"].shape[1]
            if S >= Smax:        # keep the last Smax positions, placed so
                start = S - Smax     # slot (pos % Smax) matches decode's ring
                shift = start % Smax
                new_cache = {n: torch.roll(t[:, start:], shift, 1).to(
                    cache[n].dtype) for n, t in (("k", k), ("v", v))}
            else:
                new_cache = {}
                for n, t in (("k", k), ("v", v)):
                    buf = cache[n].clone()
                    buf[:, :S] = t
                    new_cache[n] = buf
    out = dense(p["wo"], o.reshape(B, S, Hq * Dh))
    return out, new_cache


def _write_slot(buf: torch.Tensor, x: torch.Tensor,
                slot: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` with x (B, 1, ...) written at ``slot`` (0-dim
    tensor, in range) along axis 1."""
    return buf.index_copy(1, slot.reshape(1).long(), x.to(buf.dtype))


def init_attn_cache(cfg, batch: int, max_len: int, dtype, device,
                    window: int | None = None) -> dict:
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim_
    Smax = min(max_len, window) if window is not None else max_len
    return {n: torch.zeros((batch, Smax, Hkv, Dh), dtype=dtype,
                           device=device) for n in ("k", "v")}
