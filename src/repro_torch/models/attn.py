"""GQA attention block (dense / local-window) with KV-cache decode."""

from __future__ import annotations

import torch

from ..distributed.collectives import axis_index, pmax, psum
from ..distributed.sharding import P as P_, GradSpec, cache_pspecs, shard_map
from .layers import (ParamRng, init_dense, dense, apply_rope,
                     flash_attention, decode_attention, mm32, NEG_INF,
                     write_into, write_slot)

__all__ = ["init_attn", "attn_block", "init_attn_cache",
           "write_prompt_mesh"]


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
               positions: torch.Tensor | None = None, rules=None,
               donate: bool = False):
    """x: (B, S, D).  Returns (out, new_cache).

    - forward:  cache None                      -> flash attention
    - prefill:  cache dict (zeroed)             -> flash + cache write
    - decode:   cache dict, S == 1, cache_len   -> cached attention
      (the new K/V is written at slot ``cache_len % Smax``: a ring buffer
      for windowed layers, a linear buffer otherwise)

    ``cache_len`` is a 0-dim integer tensor on the device.  The input
    cache is not written; the new cache is a copy.  With ``donate`` the
    new entries are written into the input cache's tensors, which are
    returned.

    ``rules`` with a mesh: ``x``, the weights and the cache are DTensors
    and the block takes the reference's mesh layout (``_attn_mesh``).
    """
    B, S, D = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    decode = cache is not None and S == 1 and cache_len is not None

    mesh = rules is not None and rules.mesh is not None
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
        if decode and not mesh:      # the mesh's decode reads cache_len
            positions = positions + cache_len.reshape(-1, 1)
    if mesh:
        o, new_cache = _attn_mesh(*(dense(p[n], x) for n in ("wq", "wk", "wv")),
                                  positions, cfg, window, cache, cache_len,
                                  rules, decode, donate)
        # the flat heads keep the heads' layout, so the row-parallel
        # product's gradient comes back in a layout the heads' view takes
        # (an uneven head split has none)
        heads_tp = "tp" if Hq % _tp(rules)[0] == 0 and not decode else None
        o = rules.act(o.reshape(B, S, Hq * Dh), "dp", None, heads_tp)
        return dense(p["wo"], o), new_cache
    q = dense(p["wq"], x).reshape(B, S, Hq, Dh)
    k = dense(p["wk"], x).reshape(B, S, Hkv, Dh)
    v = dense(p["wv"], x).reshape(B, S, Hkv, Dh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_frac)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_frac)

    if decode:
        Smax = cache["k"].shape[1]
        slot = cache_len % Smax
        kc = write_slot(cache["k"], k, slot, donate)
        vc = write_slot(cache["v"], v, slot, donate)
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
                if donate:
                    new_cache = {n: write_into(cache[n], t)
                                 for n, t in new_cache.items()}
            else:
                new_cache = {}
                for n, t in (("k", k), ("v", v)):
                    buf = cache[n] if donate else cache[n].clone()
                    buf[:, :S] = t
                    new_cache[n] = buf
    out = dense(p["wo"], o.reshape(B, S, Hq * Dh))
    return out, new_cache


def _tp(rules) -> tuple:
    """(size, this rank's index) of the rules' tp axis (1, 0 without)."""
    if rules.tp is None:
        return 1, 0
    return (rules.mesh.size(rules.mesh.mesh_dim_names.index(rules.tp)),
            rules.mesh.get_local_rank(rules.tp))


def _attn_mesh(q, k, v, positions, cfg, window, cache, cache_len, rules,
               decode, donate=False):
    """The mesh path of ``attn_block`` after the projections (q, k, v as
    (B, S, heads * Dh)): (o (B, S, Hq, Dh), new cache).

    Forward and prefill: the reference's pins (q sharded on heads over
    tp when they divide it, ``hq_ok``; k / v on heads when there are at
    least tp of them, ``kv_ax``, else replicated), then RoPE and the
    blockwise flash on each rank's shards (``shard_map``).  A rank whose
    q heads are a slice of the heads gets the kv heads of those q heads
    (q head h reads kv head h // G): with kv replicated over tp, each
    rank takes its kv slice (or, when the groups straddle ranks, one kv
    head per q head), and its kv gradient is a partial sum over tp.

    Decode: the 2D layout's cache (sequence over tp, batch over dp):
    each rank writes the new entry if its slot lies in its sequence
    chunk and attends over its chunk; the softmax's max and sum and the
    P V product are reduced over tp.  At one tp rank this is the
    one-device arithmetic.

    ``donate``: the new entries are written into ``cache``'s local shards
    (``write_into``, ``write_slot``) and its tensors returned.
    """
    B, S = q.shape[:2]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = Hq // Hkv
    mesh = rules.mesh
    tp_size, tp_rank = _tp(rules)

    def heads(t, n, ax):
        """(B, S, n * Dh) -> (B, S, n, Dh) pinned with its heads on
        ``ax``: the flat dim is placed first where the heads divide the
        axis (an uneven head split has no view)."""
        even = ax is not None and n % tp_size == 0
        t = rules.act(t, "dp", None, ax if even else None)
        return rules.act(t.reshape(B, S, n, Dh), "dp", None, ax, None)

    if decode:
        return _decode_mesh(heads(q, Hq, None), heads(k, Hkv, None),
                            heads(v, Hkv, None), cache, cache_len, cfg,
                            rules, tp_size, tp_rank, donate)
    hq_ok = Hq % tp_size == 0
    kv_ax = "tp" if Hkv >= tp_size else None
    q = heads(q, Hq, "tp" if hq_ok else None)
    k = heads(k, Hkv, kv_ax)
    v = heads(v, Hkv, kv_ax)
    # kv enters the local flash sharded only where its shards pair with
    # the rank's q heads
    kv_in = "tp" if kv_ax == "tp" and hq_ok and Hkv % tp_size == 0 else None
    sliced = hq_ok and kv_in is None and tp_size > 1
    qs = rules.spec("dp", None, "tp" if hq_ok else None, None)
    ks = rules.spec("dp", None, kv_in, None)

    def local(ql, kl, vl):
        pos = positions.to(ql.device)
        ql = apply_rope(ql, pos, cfg.rope_theta, cfg.rope_frac)
        kl = apply_rope(kl, pos, cfg.rope_theta, cfg.rope_frac)
        k_roped = kl
        if sliced:
            hl = ql.shape[2]
            h0 = tp_rank * hl
            lo, hi = h0 // G, (h0 + hl - 1) // G + 1
            if hl % G == 0 or G % hl == 0:
                kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
            else:                    # groups straddle ranks: one per q head
                idx = torch.arange(h0, h0 + hl, device=kl.device) // G
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        o = flash_attention(ql, kl, vl, True, window, cfg.attn_chunk_q,
                            cfg.attn_chunk_kv)
        return o, k_roped

    kv_grad = GradSpec(ks, (rules.tp,)) if sliced else ks
    o, k = shard_map(local, mesh, (qs, ks, ks), (qs, ks),
                     (qs, kv_grad, kv_grad))(q, k, v)
    o = rules.act(o, "dp", None, "tp" if hq_ok else None, None)
    new_cache = None
    if cache is not None:        # prefill: persist the (window-)cache
        new_cache = write_prompt_mesh(cache, {"k": k, "v": v}, mesh, donate)
    return o, new_cache


def _placed_spec(t) -> P_:
    """The spec of a DTensor as it is placed."""
    names = [[] for _ in range(t.ndim)]
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            names[pl.dim].append(name)
    return P_(*(tuple(n) for n in names))


def write_prompt_mesh(cache: dict, new: dict, mesh, donate: bool) -> dict:
    """Prefill's cache write on the mesh: the prompt's entries ``new``
    ({name: (B, S, ...)} DTensors) written into the cache's tensors as
    they are placed (batch over dp, the sequence over tp or whole), each
    rank writing its own sequence range of its local shard: positions
    [0, S), or for a prompt as long as the cache or longer (a ring) its
    last Smax entries rolled as the one-device path rolls them.  Returns
    the cache's tensors written in place (``donate``) or new ones.  A
    prompt as long as the cache enters laid out as the cache is; any
    other enters whole along the sequence."""
    out = {}
    for n, t in new.items():
        buf = cache[n]
        S, Smax = t.shape[1], buf.shape[1]
        cspec = _placed_spec(buf)
        seq = cspec[1]
        tspec = P_(cspec[0], seq if S == Smax else None, *cspec[2:])
        r = axis_index((mesh, seq)) if seq is not None else 0

        def local(bl, tl):
            tl = tl.to(bl.dtype)
            s_loc = bl.shape[1]
            off = r * s_loc
            bl = bl if donate else bl.clone()
            if S == Smax:            # tl holds this rank's range
                bl.copy_(tl)
            elif S > Smax:           # ring: position j holds the prompt's
                start = S - Smax     # entry start + (j - start) mod Smax
                j = torch.arange(off, off + s_loc, device=tl.device)
                bl.copy_(tl.index_select(1, start + (j - start) % Smax))
            elif off < S:
                hi = min(s_loc, S - off)
                bl[:, :hi] = tl[:, off:off + hi]
            return bl

        out[n] = shard_map(local, mesh, (cspec, tspec), cspec)(buf, t)
        if donate:
            out[n] = write_into(buf, out[n])
    return out


def _decode_mesh(q, k, v, cache, cache_len, cfg, rules, tp_size, tp_rank,
                 donate=False):
    """Decode on the 2D layout: (o, {"k", "v"} new caches; with
    ``donate`` the input cache's tensors, written in place)."""
    mesh = rules.mesh
    cspec = cache_pspecs({"k": cache["k"]}, cfg, rules)["k"]
    seq = cspec[1] is not None
    rows = rules.spec("dp", None, None, None)
    axis = (mesh, rules.tp)

    def local(ql, kl, vl, kc, vc, n):
        pos = n.reshape(1, 1) + torch.arange(1, device=ql.device)[None, :]
        ql = apply_rope(ql, pos, cfg.rope_theta, cfg.rope_frac)
        kl = apply_rope(kl, pos, cfg.rope_theta, cfg.rope_frac)
        s_loc = kc.shape[1]
        Smax = s_loc * tp_size if seq else s_loc
        slot = n % Smax
        off = tp_rank * s_loc if seq else None
        kc = write_slot(kc, kl, slot, donate, off)
        vc = write_slot(vc, vl, slot, donate, off)
        n_valid = torch.clamp(n + 1, max=Smax)
        if not seq or tp_size == 1:
            return decode_attention(ql, kc, vc, n_valid), kc, vc
        return (_decode_attention_split(ql, kc, vc, n_valid,
                                        tp_rank * s_loc, axis), kc, vc)

    o, kc, vc = shard_map(local, mesh, (rows, rows, rows, cspec, cspec, P_()),
                          (rows, cspec, cspec))(
        q, k, v, cache["k"], cache["v"], cache_len)
    if donate:
        kc, vc = write_into(cache["k"], kc), write_into(cache["v"], vc)
    return o, {"k": kc, "v": vc}


def _decode_attention_split(q, kc, vc, n_valid, off, axis):
    """``decode_attention`` over a cache whose sequence is split over
    ``axis``: this rank holds positions [off, off + its length); the
    softmax's max and sum and the P V product are reduced over the axis."""
    B, _, Hq, D = q.shape
    s_loc, Hkv = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    s = mm32(q.reshape(B, Hkv, G, D), kc, "bhgd,bkhd->bhgk") * D ** -0.5
    pos = off + torch.arange(s_loc, device=q.device)[None, :]
    mask = pos < n_valid.reshape(-1, 1)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    e = torch.exp(s - pmax(s.amax(-1, keepdim=True), axis))
    p = e / psum(e.sum(-1, keepdim=True), axis)
    o = psum(mm32(p.to(vc.dtype), vc, "bhgk,bkhd->bhgd"), axis)
    return o.reshape(B, 1, Hq, vc.shape[-1]).to(q.dtype)


def init_attn_cache(cfg, batch: int, max_len: int, dtype, device,
                    window: int | None = None) -> dict:
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim_
    Smax = min(max_len, window) if window is not None else max_len
    return {n: torch.zeros((batch, Smax, Hkv, Dh), dtype=dtype,
                           device=device) for n in ("k", "v")}
