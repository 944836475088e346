"""DeepSeek-V2 multi-head latent attention (arXiv:2405.04434).

K/V are decompressed from a small shared latent (kv_lora) per token; RoPE
lives on a decoupled per-token key of rope_dim dims.  Two execution paths:

- prefill/forward: decompress K/V and run flash attention (MHA);
- decode: the **absorbed** form: W_UK is folded into the query so
  attention scores are taken directly against the latent cache
  (kv_lora + rope_dim per token).
"""

from __future__ import annotations

import torch

from .layers import (ParamRng, init_dense, dense, init_norm, apply_norm,
                     apply_rope, flash_attention, mm32, NEG_INF)

__all__ = ["init_mla", "mla_block", "init_mla_cache"]


def init_mla(rng: ParamRng, cfg, dtype) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qd = m.nope_dim + m.rope_dim
    p = {
        "wkv_a": init_dense(rng, D, m.kv_lora + m.rope_dim, dtype),
        "kv_norm": init_norm(rng, "rmsnorm", m.kv_lora, dtype),
        "wk_b": init_dense(rng, m.kv_lora, H * m.nope_dim, dtype),
        "wv_b": init_dense(rng, m.kv_lora, H * m.v_dim, dtype),
        "wo": init_dense(rng, H * m.v_dim, D, dtype,
                         scale=(H * m.v_dim) ** -0.5),
    }
    if m.q_lora:
        p["wq_a"] = init_dense(rng, D, m.q_lora, dtype)
        p["q_norm"] = init_norm(rng, "rmsnorm", m.q_lora, dtype)
        p["wq_b"] = init_dense(rng, m.q_lora, H * qd, dtype)
    else:
        p["wq"] = init_dense(rng, D, H * qd, dtype)
    return p


def _queries(p, x, cfg):
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.n_heads
    if m.q_lora:
        cq = apply_norm("rmsnorm", p["q_norm"], dense(p["wq_a"], x))
        q = dense(p["wq_b"], cq)
    else:
        q = dense(p["wq"], x)
    q = q.reshape(B, S, H, m.nope_dim + m.rope_dim)
    return q[..., :m.nope_dim], q[..., m.nope_dim:]     # (nope), (rope)


def mla_block(p: dict, x: torch.Tensor, cfg, *, cache=None, cache_len=None,
              positions=None):
    """x: (B, S, D) -> (out, new_cache).  Cache = latent (ckv, krope).

    Decode writes at ``cache_len`` clamped to the cache's last slot (as
    the reference's ``dynamic_update_slice`` clamps its start) and masks
    slots ``<= cache_len``."""
    B, S, D = x.shape
    m, H = cfg.mla, cfg.n_heads
    scale = (m.nope_dim + m.rope_dim) ** -0.5
    decode = cache is not None and S == 1 and cache_len is not None
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
        if decode:
            positions = positions + cache_len.reshape(-1, 1)

    q_nope, q_rope = _queries(p, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = dense(p["wkv_a"], x)                          # (B,S,lora+rope)
    ckv = apply_norm("rmsnorm", p["kv_norm"], kv_a[..., :m.kv_lora])
    k_rope = kv_a[..., m.kv_lora:][:, :, None, :]        # (B,S,1,rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]

    if decode:
        # ---- absorbed path: score against the latent cache directly
        Smax = cache["ckv"].shape[1]
        at = torch.clamp(cache_len, max=Smax - 1).reshape(1).long()
        ckv_c = cache["ckv"].index_copy(1, at, ckv.to(cache["ckv"].dtype))
        kr_c = cache["krope"].index_copy(1, at,
                                         k_rope.to(cache["krope"].dtype))
        # fold W_UK into q:  q_lat[b,h,l] = sum_d q_nope[b,h,d] W_UK[l,h,d]
        wk = p["wk_b"]["w"].reshape(m.kv_lora, H, m.nope_dim)
        q_lat = mm32(q_nope[:, 0], wk, "bhd,lhd->bhl")
        s = (mm32(q_lat.to(ckv_c.dtype), ckv_c, "bhl,btl->bht")
             + mm32(q_rope[:, 0].to(kr_c.dtype), kr_c, "bhr,btr->bht")
             ) * scale
        mask = torch.arange(Smax, device=x.device)[None, :] <= cache_len
        s = torch.where(mask[:, None, :], s, NEG_INF)
        pr = torch.softmax(s, -1)
        lat = mm32(pr.to(ckv_c.dtype), ckv_c, "bht,btl->bhl")  # (B,H,lora)
        wv = p["wv_b"]["w"].reshape(m.kv_lora, H, m.v_dim)
        o = mm32(lat.to(x.dtype), wv, "bhl,lhv->bhv")
        o = o.reshape(B, 1, H * m.v_dim).to(x.dtype)
        new_cache = {"ckv": ckv_c, "krope": kr_c}
    else:
        # ---- decompress and flash (MHA: Hkv == H)
        k_nope = dense(p["wk_b"], ckv).reshape(B, S, H, m.nope_dim)
        v = dense(p["wv_b"], ckv).reshape(B, S, H, m.v_dim)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, m.rope_dim)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        o = flash_attention(q, k, v, True, None, cfg.attn_chunk_q,
                            cfg.attn_chunk_kv, softmax_scale=scale)
        o = o.reshape(B, S, H * m.v_dim)
        new_cache = None
        if cache is not None:       # prefill: persist the latent cache
            new_cache = {}
            for n, t in (("ckv", ckv), ("krope", k_rope)):
                buf = cache[n].clone()
                buf[:, :S] = t
                new_cache[n] = buf
    return dense(p["wo"], o), new_cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_len, m.rope_dim), dtype=dtype,
                                 device=device)}
