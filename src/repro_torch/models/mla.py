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

from ..distributed.collectives import pmax, psum
from ..distributed.sharding import GradSpec, shard_map
from .attn import _placed_spec, _tp, write_prompt_mesh
from .layers import (ParamRng, init_dense, dense, init_norm, apply_norm,
                     apply_rope, flash_attention, mm32, NEG_INF, write_into,
                     write_slot)

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


def _queries(p, x, cfg, rules=None):
    """(B, S, H * (nope + rope)): the flat queries, heads major."""
    if not cfg.mla.q_lora:
        return dense(p["wq"], x)
    cq = dense(p["wq_a"], x)
    if rules is not None:
        cq = rules.act(cq, "dp", None, None)
    return dense(p["wq_b"], apply_norm("rmsnorm", p["q_norm"], cq))


def _split_q(q, positions, cfg):
    """Flat queries (B, S, h * qd) -> (nope, roped rope) per head."""
    m = cfg.mla
    B, S = q.shape[:2]
    q = q.reshape(B, S, -1, m.nope_dim + m.rope_dim)
    q_rope = apply_rope(q[..., m.nope_dim:], positions, cfg.rope_theta)
    return q[..., :m.nope_dim], q_rope


def _rope_k(k_rope, positions, cfg):
    """The shared rope key (B, S, rope), rotated."""
    return apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]


def _heads(q, k_nope, v, k_rope, positions, cfg):
    """Forward / prefill attention over the heads given (flat q, k_nope and
    v, heads major; the shared unrotated rope key): (flat o, the rotated
    rope key)."""
    m = cfg.mla
    B, S = q.shape[:2]
    q_nope, q_rope = _split_q(q, positions, cfg)
    k_rope = _rope_k(k_rope, positions, cfg)
    H = q_nope.shape[2]
    k_nope = k_nope.reshape(B, S, H, m.nope_dim)
    v = v.reshape(B, S, H, m.v_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.rope_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    o = flash_attention(q, k, v, True, None, cfg.attn_chunk_q,
                        cfg.attn_chunk_kv,
                        softmax_scale=(m.nope_dim + m.rope_dim) ** -0.5)
    return o.reshape(B, S, H * m.v_dim), k_rope


def _absorb_q(q, wk, cfg):
    """Decode: W_UK folded into the heads' queries, q_lat (B, h, lora):
    q_lat[b,h,l] = sum_d q_nope[b,h,d] W_UK[l,h,d]."""
    m = cfg.mla
    q = q[:, 0].reshape(q.shape[0], -1, m.nope_dim + m.rope_dim)
    wk = wk.reshape(m.kv_lora, -1, m.nope_dim)
    return mm32(q[..., :m.nope_dim], wk, "bhd,lhd->bhl")


def _attend_latent(q, q_lat, ckv, k_rope, cache, n, cfg, off=0, axis=None,
                   donate=False):
    """Decode's scores against the latent cache: the new entry written at
    ``n`` clamped to the cache's last slot (as the reference's
    ``dynamic_update_slice`` clamps its start), slots ``<= n`` attended.
    ``q``: the flat queries of every head; ``q_lat``: ``_absorb_q``'s.
    Returns (lat (B, H, lora) fp32, new cache).  With ``axis`` the cache
    holds positions [off, off + its length) of a sequence split over the
    axis: the softmax's max and sum and the P·ckv product are reduced over
    it.  ``donate``: the entry is written into ``cache``'s tensors."""
    m = cfg.mla
    scale = (m.nope_dim + m.rope_dim) ** -0.5
    pos = n.reshape(-1, 1) + torch.arange(1, device=q.device)[None, :]
    _, q_rope = _split_q(q, pos, cfg)
    k_rope = _rope_k(k_rope, pos, cfg)
    s_loc = cache["ckv"].shape[1]
    if axis is None:
        at, split = torch.clamp(n, max=s_loc - 1), None
    else:
        at, split = torch.clamp(n, max=s_loc * _axis_len(axis) - 1), off
    ckv_c = write_slot(cache["ckv"], ckv, at, donate, split)
    kr_c = write_slot(cache["krope"], k_rope, at, donate, split)
    s = (mm32(q_lat.to(ckv_c.dtype), ckv_c, "bhl,btl->bht")
         + mm32(q_rope[:, 0].to(kr_c.dtype), kr_c, "bhr,btr->bht")) * scale
    mask = off + torch.arange(s_loc, device=q.device)[None, :] <= n
    s = torch.where(mask[:, None, :], s, NEG_INF)
    if axis is None:
        pr = torch.softmax(s, -1)
        lat = mm32(pr.to(ckv_c.dtype), ckv_c, "bht,btl->bhl")
    else:
        e = torch.exp(s - pmax(s.amax(-1, keepdim=True), axis))
        pr = e / psum(e.sum(-1, keepdim=True), axis)
        lat = psum(mm32(pr.to(ckv_c.dtype), ckv_c, "bht,btl->bhl"), axis)
    return lat, {"ckv": ckv_c, "krope": kr_c}


def _axis_len(axis) -> int:
    mesh, name = axis
    return mesh.size(mesh.mesh_dim_names.index(name))


def _values(lat, wv, cfg, dtype):
    """Decode: the heads' outputs from their latents, flat (B, 1, h * v)."""
    m = cfg.mla
    wv = wv.reshape(m.kv_lora, -1, m.v_dim)
    o = mm32(lat.to(dtype), wv, "bhl,lhv->bhv")
    return o.reshape(o.shape[0], 1, -1).to(dtype)


def mla_block(p: dict, x: torch.Tensor, cfg, *, cache=None, cache_len=None,
              rules=None, donate: bool = False):
    """x: (B, S, D) -> (out, new_cache).  Cache = latent (ckv, krope).

    Decode writes at ``cache_len`` clamped to the cache's last slot and
    masks slots ``<= cache_len``.  ``donate``: the cache's tensors are
    written in place and returned.

    ``rules`` with a mesh: ``x``, the weights and the cache are DTensors;
    the projections keep their specs' layout (the heads over tp) and the
    attention runs on each rank's heads, decode's latent scores on its
    part of the cache (``_mla_mesh``)."""
    B, S, D = x.shape
    m = cfg.mla
    decode = cache is not None and S == 1 and cache_len is not None

    q = _queries(p, x, cfg, rules)
    kv_a = dense(p["wkv_a"], x)                          # (B,S,lora+rope)
    if rules is not None:
        kv_a = rules.act(kv_a, "dp", None, None)
    ckv = apply_norm("rmsnorm", p["kv_norm"], kv_a[..., :m.kv_lora])
    k_rope = kv_a[..., m.kv_lora:]                       # (B,S,rope)
    if rules is not None:
        return _mla_mesh(p, q, ckv, k_rope, cfg, cache, cache_len, decode,
                         rules, donate)

    if decode:
        # ---- absorbed path: score against the latent cache directly
        q_lat = _absorb_q(q, p["wk_b"]["w"], cfg)
        lat, new_cache = _attend_latent(q, q_lat, ckv, k_rope, cache,
                                        cache_len, cfg, donate=donate)
        o = _values(lat, p["wv_b"]["w"], cfg, x.dtype)
    else:
        # ---- decompress and flash (MHA: Hkv == H)
        positions = torch.arange(S, device=x.device)[None, :]
        o, k_rope = _heads(q, dense(p["wk_b"], ckv), dense(p["wv_b"], ckv),
                           k_rope, positions, cfg)
        new_cache = None
        if cache is not None:       # prefill: persist the latent cache
            new_cache = {}
            for n, t in (("ckv", ckv), ("krope", k_rope)):
                buf = cache[n] if donate else cache[n].clone()
                buf[:, :S] = t
                new_cache[n] = buf
    return dense(p["wo"], o), new_cache


def _mla_mesh(p, q, ckv, k_rope, cfg, cache, cache_len, decode, rules,
              donate=False):
    """``mla_block`` after its shared projections, on the mesh.  The heads
    go over tp where they divide it (``wq_b``, ``wk_b``, ``wv_b`` and
    ``wo`` as their specs place them); the latent ``ckv`` and the rope key
    are shared by every head, so replicated over tp, each rank's gradient
    of them a partial sum over tp.

    Forward / prefill: the per-head products and the flash on each rank's
    heads (``shard_map``).  Decode: W_UK folded into each rank's heads'
    queries, the latents gathered over the heads, the scores against the
    cache's sequence chunk of each tp rank (softmax reduced over tp), and
    each rank's heads' values from W_UV.  At one tp rank this is the
    one-device arithmetic."""
    m = cfg.mla
    B, S = q.shape[:2]
    mesh = rules.mesh
    tp_size, _ = _tp(rules)
    hq = "tp" if cfg.n_heads % tp_size == 0 else None
    heads = rules.spec("dp", None, hq)
    whole = rules.spec("dp", None, None)
    q = rules.act(q, "dp", None, hq)
    shared_grad = GradSpec(whole, (rules.tp,)) if hq and tp_size > 1 \
        else whole
    if not decode:
        positions = torch.arange(S, device=q.device)[None, :]
        kn, v = (rules.act(dense(p[n], ckv), "dp", None, hq)
                 for n in ("wk_b", "wv_b"))

        def local(ql, kl, vl, rl):
            return _heads(ql, kl, vl, rl, positions.to(ql.device), cfg)

        o, k_rope = shard_map(local, mesh, (heads, heads, heads, whole),
                              (heads, whole),
                              (heads, heads, heads, shared_grad))(
            q, kn, v, k_rope)
        new_cache = None
        if cache is not None:       # prefill: persist the latent cache
            new_cache = write_prompt_mesh(
                cache, {"ckv": ckv, "krope": k_rope}, mesh, donate)
        return dense(p["wo"], rules.act(o, "dp", None, hq)), new_cache

    wspec = rules.spec(None, hq)              # (lora, h * d): ZeRO gathered
    q_lat = shard_map(lambda ql, w: _absorb_q(ql, w, cfg), mesh,
                      (heads, wspec), rules.spec("dp", hq, None))(
        q, p["wk_b"]["w"])
    seq = any(pl.is_shard(1) for pl in cache["ckv"].placements)
    axis = (mesh, rules.tp) if seq and tp_size > 1 else None
    lat_spec = rules.spec("dp", None, None)
    cache_spec = {k: _placed_spec(t) for k, t in cache.items()}

    def attend(ql, latl, cl, rl, cc, n):
        off = 0
        if axis is not None:
            off = mesh.get_local_rank(rules.tp) * cc["ckv"].shape[1]
        return _attend_latent(ql, latl, cl, rl, cc, n, cfg, off, axis,
                              donate)

    lat, new_cache = shard_map(
        attend, mesh, (whole, lat_spec, whole, whole, cache_spec,
                       rules.spec()),
        (lat_spec, cache_spec))(q, q_lat, ckv, k_rope, cache, cache_len)
    if donate:
        new_cache = {k: write_into(cache[k], t) for k, t in new_cache.items()}
    o = shard_map(lambda ll, w: _values(ll, w, cfg, q.dtype), mesh,
                  (rules.spec("dp", hq, None), wspec), heads)(
        lat, p["wv_b"]["w"])
    return dense(p["wo"], o), new_cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_len, m.rope_dim), dtype=dtype,
                                 device=device)}
