"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060), chunked
matmul form: intra-chunk (L x L) products and one carry across chunks.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t ;   y_t = C_t · h_t + D x_t

Decode is the O(1) recurrence over the carried (H, N, P) state.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import ParamRng, init_dense, dense, rmsnorm

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


def ssd_block(p: dict, x: torch.Tensor, cfg, *, cache=None, cache_len=None):
    """x: (B, S, D) -> (out, new_cache).  cache = {'state', 'conv'}."""
    s = cfg.ssd
    B, S, D = x.shape
    din = s.expand * D
    H = din // s.head_dim
    P_ = s.head_dim
    G, N = s.n_groups, s.d_state
    decode = cache is not None and S == 1 and cache_len is not None

    z = dense(p["wz"], x)                               # (B,S,din)
    u = dense(p["wx"], x)
    u, conv_state = _conv1d(p["conv_x"], u,
                            cache["conv"] if decode else None)
    u = F.silu(u)
    Bv = dense(p["wB"], x).reshape(B, S, G, N).float()
    Cv = dense(p["wC"], x).reshape(B, S, G, N).float()
    dt = F.softplus(dense(p["wdt"], x).float() + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])                          # (H,) < 0
    uh = u.reshape(B, S, H, P_).float()
    rep = H // G                                        # heads per group
    Bh = Bv.repeat_interleave(rep, dim=2)               # (B,S,H,N)
    Ch = Cv.repeat_interleave(rep, dim=2)

    if decode:
        st = cache["state"].float()                     # (B,H,N,P)
        a = torch.exp(dt[:, 0] * A[None, :])            # (B,H)
        inc = torch.einsum("bhn,bhp->bhnp", Bh[:, 0] * dt[:, 0, :, None],
                           uh[:, 0])
        st = a[..., None, None] * st + inc
        y = torch.einsum("bhn,bhnp->bhp", Ch[:, 0], st)
        y = y + p["D_skip"][None, :, None] * uh[:, 0]
        ys = y.reshape(B, 1, din)
        new_cache = {"state": st.to(cache["state"].dtype), "conv": conv_state}
    else:
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
            (B, H, N, P_), dtype=torch.float32, device=x.device)
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
        ys = y.reshape(B, S, din)
        new_cache = None
        if cache is not None:        # prefill: persist the final state
            new_cache = {"state": st.to(cache["state"].dtype),
                         "conv": conv_state}

    ys = rmsnorm(ys.to(x.dtype), p["norm"]["scale"])
    ys = ys * F.silu(z)
    return dense(p["out_proj"], ys), new_cache


def init_ssd_cache(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssd
    din = s.expand * cfg.d_model
    H = din // s.head_dim
    return {"state": torch.zeros((batch, H, s.d_state, s.head_dim),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.conv_width - 1, din), dtype=dtype,
                                device=device)}
