"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t²) * (i_t * u_t)
    a_t = exp(-c · softplus(Λ) * σ(r_t))

Gates r, i are block-diagonal linear maps (n_heads blocks).  Prefill and
forward scan over time in log2(S) doubling steps (the reference takes an
associative scan: the same recurrence, summed in another order); decode is
the O(1) recurrence.  The block wraps the recurrence Griffin-style: gelu
gate branch * (conv1d -> RG-LRU) branch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import GradSpec, shard_map
from .attn import _tp
from .layers import ParamRng, activation, init_dense, dense, write_into

__all__ = ["init_rglru", "rglru_block", "init_rglru_cache"]


def _block_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal (H, w, w) map over (B, S, W=H·w)."""
    B, S, W = x.shape
    n_heads = w.shape[0]
    xh = x.reshape(B, S, n_heads, W // n_heads)
    y = torch.einsum("bshi,hij->bshj", xh, w.to(x.dtype))
    return y.reshape(x.shape)


def init_rglru(rng: ParamRng, cfg, dtype) -> dict:
    g = cfg.rglru
    D, W, H = cfg.d_model, g.width, cfg.n_heads
    wh = W // H
    std = wh ** -0.5
    if rng.meta:         # shapes only (so also under a fake tensor mode)
        lam = np.empty(W, np.float32)
    else:                # softplus^-1 so that a^c lies in [0.9, 0.999]
        lin = torch.linspace(0.9, 0.999, W, dtype=torch.float32)
        lam = torch.log(torch.expm1(-torch.log(lin) / g.c)).numpy()
    return {
        "wy": init_dense(rng, D, W, dtype),            # gelu gate branch
        "wx": init_dense(rng, D, W, dtype),            # recurrence branch
        "conv": {"w": rng.normal((W, g.conv_width), 0.1, dtype),
                 "b": rng.full((W,), 0.0, dtype)},
        "gate": {"r": {"blocks": rng.normal((H, wh, wh), std, dtype),
                       "b": rng.full((W,), 0.0, dtype)},
                 "i": {"blocks": rng.normal((H, wh, wh), std, dtype),
                       "b": rng.full((W,), 0.0, dtype)}},
        "lam": rng.tensor(lam, torch.float32),           # Λ (W,) fp32
        "out_proj": init_dense(rng, W, D, dtype, scale=W ** -0.5),
    }


def _causal_conv(p, x, conv_state=None):
    """Depthwise causal conv1d; x: (B, S, W), weight (W, cw).

    ``conv_state``: (B, cw-1, W) carry for decode; returns (y, new_state).
    """
    W, cw = p["w"].shape
    if conv_state is None:
        pad = torch.zeros((x.shape[0], cw - 1, W), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], 1)                          # (B, S+cw-1, W)
    w = p["w"].to(x.dtype)
    y = sum(xp[:, i:i + x.shape[1]] * w[None, None, :, i] for i in range(cw))
    y = y + p["b"].to(x.dtype)
    new_state = xp[:, -(cw - 1):] if cw > 1 else pad
    return y, new_state


def _rglru_scan(log_a: torch.Tensor, bx: torch.Tensor, h0=None):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 (time).

    log_a, bx: (B, S, W) fp32.  Returns h (B, S, W) fp32.  Step k
    combines each element with the one 2^k before it, (a1, b1) then (a2,
    b2) -> (a1 + a2, exp(a2) b1 + b2), the reference's combine.
    """
    if h0 is not None:
        # fold the initial state into the first step
        bx = bx.clone()
        bx[:, 0] += torch.exp(log_a[:, 0]) * h0
    a, b = log_a, bx
    S = a.shape[1]
    for k in range(math.ceil(math.log2(S)) if S > 1 else 0):
        sh = 1 << k
        a_prev = F.pad(a[:, :-sh], (0, 0, sh, 0))        # identity (0, 0)
        b_prev = F.pad(b[:, :-sh], (0, 0, sh, 0))
        b = torch.exp(a) * b_prev + b
        a = a_prev + a
    return b


def _gates(g: dict, u: torch.Tensor):
    """The gates' pre-activations (r, i) of ``u`` (B, S, W)."""
    r = _block_linear(g["r"]["blocks"], u) + g["r"]["b"].to(u.dtype)
    i = _block_linear(g["i"]["blocks"], u) + g["i"]["b"].to(u.dtype)
    return r, i


def _gates_slice(g: dict, u: torch.Tensor, c0: int, c1: int):
    """``_gates`` of channels [c0, c1) from ``u`` over every channel: the
    block products of the heads those channels meet, then their slice.
    (Not ``_gates`` on the whole width: a slice's backward adds u's
    gradients in another order.)"""
    wh = g["r"]["blocks"].shape[1]
    h0, h1 = c0 // wh, -(-c1 // wh)
    part = u[..., h0 * wh:h1 * wh]
    return tuple(
        _block_linear(g[n]["blocks"][h0:h1], part)[..., c0 - h0 * wh:
                                                   c1 - h0 * wh]
        + g[n]["b"][c0:c1].to(u.dtype) for n in ("r", "i"))


def _lru(lam, u, r, i, cfg, h, decode: bool):
    """The RG-LRU over the conv's output ``u`` (B, S, W) and the gates'
    pre-activations: (h (B, S, W) fp32, the last state in ``h``'s dtype or
    None).  ``h``: the carried state (B, W) (decode, prefill) or None."""
    g = cfg.rglru
    decay = -g.c * F.softplus(lam)                        # (W,) fp32, < 0
    log_a = decay * torch.sigmoid(r.float())               # (B,S,W)
    gated = torch.sigmoid(i.float()) * u.float()
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * gated

    if decode:
        h_new = torch.exp(log_a[:, 0]) * h.float() + bx[:, 0]
        return h_new[:, None], h_new.to(h.dtype)
    hs = _rglru_scan(log_a, bx, h.float() if h is not None else None)
    return hs, (hs[:, -1].to(h.dtype) if h is not None else None)


def _recurrence(p: dict, u: torch.Tensor, cfg, cache, decode: bool):
    """The conv, the gates and the RG-LRU over ``u`` (B, S, W): (h (B, S,
    W) fp32, new cache or None).  ``p``: the block's ``conv``, ``gate``
    and ``lam``; on a mesh each rank's channels (whole heads)."""
    u, conv_state = _causal_conv(p["conv"], u,
                                 cache["conv"] if decode else None)
    r, i = _gates(p["gate"], u)
    hs, h = _lru(p["lam"], u, r, i, cfg,
                 cache["h"] if cache is not None else None, decode)
    return hs, (None if cache is None else {"h": h, "conv": conv_state})


def rglru_block(p: dict, x: torch.Tensor, cfg, *, cache=None,
                cache_len=None, rules=None, donate: bool = False):
    """x: (B, S, D) -> (out, new_cache).  cache = {'h', 'conv'}.

    ``rules`` with a mesh: ``x``, the weights and the cache are DTensors;
    the projections keep their specs' layout (the channels over tp) and
    the recurrence runs on each rank's channels (``_rglru_mesh``).
    ``donate``: the new state is written into the cache's tensors, which
    are returned."""
    S = x.shape[1]
    decode = cache is not None and S == 1 and cache_len is not None

    y = activation(dense(p["wy"], x), "gelu")             # (B,S,W)
    u = dense(p["wx"], x)
    core = {k: p[k] for k in ("conv", "gate", "lam")}
    if rules is not None:
        y, hs, new_cache = _rglru_mesh(core, y, u, cfg, cache, decode, rules)
    else:
        hs, new_cache = _recurrence(core, u, cfg, cache, decode)
    if donate and new_cache is not None:
        new_cache = {k: write_into(cache[k], t) for k, t in new_cache.items()}
    out = dense(p["out_proj"], (y.float() * hs).to(x.dtype))
    return out, new_cache


def _rglru_mesh(p, y, u, cfg, cache, decode, rules):
    """The recurrence under ``shard_map``, the batch over dp and the
    channels over tp, as the specs place ``lam``, the conv and the cache.
    Returns (y, h, new cache) with y and h in the channels' layout, for
    the row-parallel output projection.  Each rank's weight gradients are
    partial sums over dp.

    Where whole heads divide tp, the gates' blocks are split with the
    channels and one ``shard_map`` runs ``_recurrence`` on each rank's
    heads.  Else (``recurrentgemma-2b``: 10 heads, tp 16) the blocks stay
    replicated, as ``enforce_divisibility`` leaves them, and a rank's
    channels may cut a head: ``_rglru_uneven``."""
    tp_size, _ = _tp(rules)
    ch = "tp" if cfg.rglru.width % tp_size == 0 else None
    if ch and cfg.n_heads % tp_size:
        return _rglru_uneven(p, y, u, cfg, cache, decode, rules)
    y = rules.act(y, "dp", None, ch)
    u = rules.act(u, "dp", None, ch)
    c = rules.spec(ch)
    wspec = {"conv": {"w": rules.spec(ch, None), "b": c},
             "gate": {n: {"blocks": rules.spec(ch, None, None), "b": c}
                      for n in ("r", "i")},
             "lam": c}
    rows = rules.spec("dp", None, ch)
    cspec = ({"h": rules.spec("dp", ch), "conv": rules.spec("dp", None, ch)}
             if cache is not None else None)
    wgrad = {"conv": {k: GradSpec(v, rules.dp)
                      for k, v in wspec["conv"].items()},
             "gate": {n: {k: GradSpec(v, rules.dp) for k, v in d.items()}
                      for n, d in wspec["gate"].items()},
             "lam": GradSpec(c, rules.dp)}

    def local(pp, ul, cl):
        return _recurrence(pp, ul, cfg, cl, decode)

    hs, new_cache = shard_map(local, rules.mesh, (wspec, rows, cspec),
                              (rows, cspec), (wgrad, rows, cspec))(
        p, u, cache)
    if new_cache is not None:
        new_cache = {k: t.redistribute(rules.mesh, cache[k].placements)
                     for k, t in new_cache.items()}
    return y, hs, new_cache


def _rglru_uneven(p, y, u, cfg, cache, decode, rules):
    """``_rglru_mesh`` where tp does not divide the heads: the conv and
    the RG-LRU on each rank's channels (``lam``, the conv and the ``h`` /
    ``conv`` caches over tp, as the specs place them); the gates' (H, w, w)
    blocks and biases replicated.  The conv's output is gathered over tp
    for the gates alone: each rank multiplies the heads its channels meet
    and keeps its channels (``_gates_slice``).  The replicated blocks' and
    biases' gradients are partial sums over dp and tp, the gathered
    input's over tp."""
    tp_size, tp_rank = _tp(rules)
    mesh = rules.mesh
    w_loc = cfg.rglru.width // tp_size
    c0 = tp_rank * w_loc
    y = rules.act(y, "dp", None, "tp")
    u = rules.act(u, "dp", None, "tp")
    c = rules.spec("tp")
    rows = rules.spec("dp", None, "tp")
    whole = rules.spec("dp", None, None)
    conv_spec = {"w": rules.spec("tp", None), "b": c}
    state_spec = rows if decode else None
    uc, conv_state = shard_map(
        _causal_conv, mesh, (conv_spec, rows, state_spec), (rows, rows),
        ({k: GradSpec(v, rules.dp) for k, v in conv_spec.items()}, rows,
         state_spec))(p["conv"], u, cache["conv"] if decode else None)
    gspec = {n: {"blocks": rules.spec(None, None, None), "b": rules.spec(None)}
             for n in ("r", "i")}
    gsum = rules.dp + (rules.tp,)
    hspec = rules.spec("dp", "tp") if cache is not None else None

    def scan(g, lam, uf, h):
        r, i = _gates_slice(g, uf, c0, c0 + w_loc)
        return _lru(lam, uf[..., c0:c0 + w_loc], r, i, cfg, h, decode)

    hs, h = shard_map(
        scan, mesh, (gspec, c, whole, hspec), (rows, hspec),
        ({n: {k: GradSpec(v, gsum) for k, v in d.items()}
          for n, d in gspec.items()}, GradSpec(c, rules.dp),
         GradSpec(whole, (rules.tp,)), hspec))(
        p["gate"], p["lam"], rules.act(uc, "dp", None, None),
        cache["h"] if cache is not None else None)
    if cache is None:
        return y, hs, None
    return y, hs, {k: t.redistribute(mesh, cache[k].placements)
                   for k, t in (("h", h), ("conv", conv_state))}


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    g = cfg.rglru
    return {"h": torch.zeros((batch, g.width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, g.conv_width - 1, g.width),
                                dtype=dtype, device=device)}
