"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060), chunked
matmul form: intra-chunk (L x L) products and one carry across chunks.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t ;   y_t = C_t · h_t + D x_t

Decode is the O(1) recurrence over the carried (H, N, P) state.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import GradSpec, shard_map
from .attn import _tp
from .layers import ParamRng, init_dense, dense, rmsnorm, write_into

__all__ = ["init_ssd", "ssd_block", "init_ssd_cache"]


def init_ssd(rng: ParamRng, cfg, dtype) -> dict:
    s = cfg.ssd
    D = cfg.d_model
    din = s.expand * D
    H = din // s.head_dim
    G, N = s.n_groups, s.d_state
    return {
        "wz": init_dense(rng, D, din, dtype),
        "wx": init_dense(rng, D, din, dtype),
        "wB": init_dense(rng, D, G * N, dtype),
        "wC": init_dense(rng, D, G * N, dtype),
        "wdt": init_dense(rng, D, H, dtype),
        "conv_x": {"w": rng.normal((din, s.conv_width), 0.1, dtype),
                   "b": rng.full((din,), 0.0, dtype)},
        "A_log": rng.tensor(np.log(np.linspace(1.0, 16.0, H, dtype=np.float32)),
                            torch.float32),
        "dt_bias": rng.full((H,), 0.0, torch.float32),
        "D_skip": rng.full((H,), 1.0, torch.float32),
        "norm": {"scale": rng.full((din,), 1.0, dtype)},
        "out_proj": init_dense(rng, din, D, dtype, scale=din ** -0.5),
    }


def _conv1d(p, x, state=None):
    """Depthwise causal conv; x (B, S, C), weight (C, cw)."""
    C, cw = p["w"].shape
    pad = torch.zeros((x.shape[0], cw - 1, C), dtype=x.dtype,
                      device=x.device) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    w = p["w"].to(x.dtype)
    y = sum(xp[:, i:i + x.shape[1]] * w[None, None, :, i] for i in range(cw))
    return y + p["b"].to(x.dtype), xp[:, -(cw - 1):]


def _segsum(ca: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise decay exp(ca_l - ca_s), masked s ≤ l.

    ca: (..., L) fp32 cumulative log-decay -> (..., L, L).  The mask is
    applied to the exponent: upper-triangle entries overflow under exp.
    """
    L = ca.shape[-1]
    d = ca[..., :, None] - ca[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=ca.device))
    return torch.exp(torch.where(mask, d, -1e30))


def _scan(p: dict, u, Bv, Cv, dt_raw, cfg, cache, decode: bool,
          h0: int = 0):
    """The conv, the gates and the SSD over ``u`` (B, S, C): (y (B, S, C)
    fp32, new cache or None).  ``p``: the block's ``conv_x``, ``A_log``,
    ``dt_bias`` and ``D_skip``; on a mesh each rank's heads, from head
    ``h0`` (``u``, ``dt_raw`` and the cache sliced alike; ``Bv`` and
    ``Cv`` whole, each head reading its group)."""
    s = cfg.ssd
    B, S, din = u.shape
    P_ = s.head_dim
    H = din // P_                                       # this rank's heads
    G, N = s.n_groups, s.d_state
    u, conv_state = _conv1d(p["conv_x"], u,
                            cache["conv"] if decode else None)
    u = F.silu(u)
    Bv = Bv.reshape(B, S, G, N).float()
    Cv = Cv.reshape(B, S, G, N).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])       # (B,S,H)
    A = -torch.exp(p["A_log"])                          # (H,) < 0
    uh = u.reshape(B, S, H, P_).float()
    rep = s.expand * cfg.d_model // P_ // G             # heads per group
    Bh = Bv.repeat_interleave(rep, dim=2)               # (B,S,H,N)
    Ch = Cv.repeat_interleave(rep, dim=2)
    if Bh.shape[2] != H:                                # this rank's heads
        Bh, Ch = Bh[:, :, h0:h0 + H], Ch[:, :, h0:h0 + H]

    if decode:
        st = cache["state"].float()                     # (B,H,N,P)
        a = torch.exp(dt[:, 0] * A[None, :])            # (B,H)
        inc = torch.einsum("bhn,bhp->bhnp", Bh[:, 0] * dt[:, 0, :, None],
                           uh[:, 0])
        st = a[..., None, None] * st + inc
        y = torch.einsum("bhn,bhnp->bhp", Ch[:, 0], st)
        y = y + p["D_skip"][None, :, None] * uh[:, 0]
        return y.reshape(B, 1, din), {"state": st.to(cache["state"].dtype),
                                      "conv": conv_state}
    L = min(s.chunk, S)
    Sp = -(-S // L) * L
    nc = Sp // L

    def chunks(t):                                  # (B,S,...) -> (B,nc,L,...)
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, Sp - S))
        return t.reshape(B, nc, L, *t.shape[2:])

    uc, Bc, Cc, dtc = chunks(uh), chunks(Bh), chunks(Ch), chunks(dt)
    dA = dtc * A                                    # (B,nc,L,H) log-decay
    ca = torch.cumsum(dA, 2)
    # intra-chunk: Y[l] = sum_{s<=l} C_l·B_s exp(ca_l - ca_s) dt_s x_s
    att = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    dec = _segsum(ca.permute(0, 1, 3, 2))           # (B,nc,H,L,L)
    att = att * dec * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_in = torch.einsum("bchls,bcshp->bclhp", att, uc)
    # chunk summaries: S_c = sum_s exp(ca_L - ca_s) dt_s B_s ⊗ x_s
    wts = torch.exp(ca[:, :, -1:, :] - ca) * dtc    # (B,nc,L,H)
    Sc = torch.einsum("bcshn,bcsh,bcshp->bchnp", Bc, wts, uc)
    # carry states across chunks: S_c = exp(sum dA_c) S_{c-1} + Sc
    tot = torch.exp(ca[:, :, -1, :])                # (B,nc,H)
    st = cache["state"].float() if cache is not None else torch.zeros(
        (B, H, N, P_), dtype=torch.float32, device=u.device)
    st_prevs = []
    for c in range(nc):
        st_prevs.append(st)
        st = tot[:, c, :, None, None] * st + Sc[:, c]
    st_prevs = torch.stack(st_prevs, 1)             # (B,nc,H,N,P) pre-chunk
    # inter-chunk: Y[l] += C_l exp(ca_l) S_prev
    y_x = torch.einsum("bclhn,bclh,bchnp->bclhp", Cc, torch.exp(ca),
                       st_prevs)
    y = (y_in + y_x).reshape(B, Sp, H, P_)[:, :S]
    y = y + p["D_skip"][None, None, :, None] * uh
    new_cache = None
    if cache is not None:        # prefill: persist the final state
        new_cache = {"state": st.to(cache["state"].dtype),
                     "conv": conv_state}
    return y.reshape(B, S, din), new_cache


def ssd_block(p: dict, x: torch.Tensor, cfg, *, cache=None, cache_len=None,
              rules=None, donate: bool = False):
    """x: (B, S, D) -> (out, new_cache).  cache = {'state', 'conv'}.

    ``rules`` with a mesh: ``x``, the weights and the cache are DTensors;
    the projections keep their specs' layout (the heads over tp) and the
    scan runs on each rank's heads (``_ssd_mesh``).  ``donate``: the new
    state is written into the cache's tensors, which are returned."""
    S = x.shape[1]
    decode = cache is not None and S == 1 and cache_len is not None

    z = dense(p["wz"], x)                               # (B,S,din)
    u = dense(p["wx"], x)
    Bv, Cv, dt = (dense(p[n], x) for n in ("wB", "wC", "wdt"))
    core = {k: p[k] for k in ("conv_x", "A_log", "dt_bias", "D_skip")}
    if rules is not None:
        out, new_cache = _ssd_mesh(p, core, z, u, Bv, Cv, dt, cfg, cache,
                                   decode, rules)
    else:
        ys, new_cache = _scan(core, u, Bv, Cv, dt, cfg, cache, decode)
        ys = rmsnorm(ys.to(x.dtype), p["norm"]["scale"])
        ys = ys * F.silu(z)
        out = dense(p["out_proj"], ys)
    if donate and new_cache is not None:
        new_cache = {k: write_into(cache[k], t) for k, t in new_cache.items()}
    return out, new_cache


def _ssd_mesh(p, core, z, u, Bv, Cv, dt, cfg, cache, decode, rules):
    """``ssd_block`` after its projections, on the mesh: the scan on each
    rank's heads (``_scan_mesh``).  The gated norm runs over the whole
    inner width (its scale is replicated): the scan's output is gathered
    over tp for it, then split again for the row-parallel output
    projection."""
    ch = _heads_axis(cfg, rules)
    z = rules.act(z, "dp", None, ch)
    ys, new_cache = _scan_mesh(core, u, Bv, Cv, dt, cfg, cache, decode,
                               rules)
    ys = rules.act(ys, "dp", None, None)
    ys = rmsnorm(ys.to(z.dtype), p["norm"]["scale"])
    ys = rules.act(ys, "dp", None, ch) * F.silu(z)
    if new_cache is not None:
        new_cache = {k: t.redistribute(rules.mesh, cache[k].placements)
                     for k, t in new_cache.items()}
    return dense(p["out_proj"], ys), new_cache


def _heads_axis(cfg, rules):
    """"tp" where the SSD heads divide the tp axis (they are split over
    it), else None."""
    s = cfg.ssd
    H = s.expand * cfg.d_model // s.head_dim
    return "tp" if H % _tp(rules)[0] == 0 else None


def _scan_mesh(core, u, Bv, Cv, dt, cfg, cache, decode, rules):
    """``_scan`` under ``shard_map``: the batch over dp and the heads over
    tp (where they divide it), as the specs place ``conv_x``, ``A_log``,
    ``dt_bias``, ``D_skip`` and the cache; ``Bv``, ``Cv`` (one group's B
    and C serve several heads) and ``dt`` replicated over tp, each rank
    taking its heads' part.  Returns (y in the heads' layout, new cache as
    the specs place it).

    The one sum tp reorders here is that of B's and C's gradients over
    the heads: one device sums each group's heads in order (the backward
    of ``repeat_interleave``); on the mesh each rank sums its own heads,
    and the ranks' partial sums are added by an all-reduce over tp, in
    the collective's grouping.  Summing in one device's order would take
    a gather of every head's gradient (H / n_groups times the bytes) in
    place of that all-reduce of partial sums, which is the layout the
    reference's specs price."""
    tp_size, tp_rank = _tp(rules)
    s = cfg.ssd
    H = s.expand * cfg.d_model // s.head_dim
    ch = _heads_axis(cfg, rules)
    u = rules.act(u, "dp", None, ch)
    Bv, Cv = (rules.act(t, "dp", None, None) for t in (Bv, Cv))
    dt = rules.act(dt, "dp", None, None)
    c = rules.spec(ch)
    wspec = {"conv_x": {"w": rules.spec(ch, None), "b": c},
             "A_log": c, "dt_bias": c, "D_skip": c}
    wgrad = {"conv_x": {k: GradSpec(v, rules.dp)
                        for k, v in wspec["conv_x"].items()},
             **{k: GradSpec(c, rules.dp) for k in ("A_log", "dt_bias",
                                                    "D_skip")}}
    rows = rules.spec("dp", None, ch)
    whole = rules.spec("dp", None, None)
    # each tp rank reads a part of B and C: their gradients sum over tp
    bc_grad = GradSpec(whole, (rules.tp,)) if ch and tp_size > 1 else whole
    cspec = ({"state": rules.spec("dp", ch, None, None),
              "conv": rules.spec("dp", None, ch)}
             if cache is not None else None)
    h0 = tp_rank * (H // tp_size) if ch else 0

    def local(pp, ul, bl, cl, dl, cc):
        return _scan(pp, ul, bl, cl, dl, cfg, cc, decode, h0)

    return shard_map(
        local, rules.mesh, (wspec, rows, whole, whole, rows, cspec),
        (rows, cspec), (wgrad, rows, bc_grad, bc_grad, rows, cspec))(
        core, u, Bv, Cv, dt, cache)


def init_ssd_cache(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssd
    din = s.expand * cfg.d_model
    H = din // s.head_dim
    return {"state": torch.zeros((batch, H, s.d_state, s.head_dim),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.conv_width - 1, din), dtype=dtype,
                                device=device)}
