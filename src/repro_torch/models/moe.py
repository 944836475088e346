"""Top-k routed mixture-of-experts with expert parallelism.

The reference's ``moe_ffn``.  Tokens pick their ``top_k`` experts from a
float32 router; each expert takes at most ``moe_capacity`` tokens,
earliest first (capacity drops); outputs are scatter-added back per
token.  With ``axis_name=None`` every expert is local (one device).
Under a mesh (``shard_map`` in ``transformer.py``) ``axis_name`` is the
expert axis (``(mesh, "model")``): tokens arrive replicated over it, each
rank routes every token and dispatches those routed to its own experts,
and one ``psum`` over the axis combines the routed outputs.
``axis_data`` (decode's 2D layout) also splits the experts' hidden dim
over the data axes: the first products are partial contractions summed
over them, and the output is that rank's slice of the hidden dim.

``lax.top_k`` orders equal values by index; the port takes the same
order from a stable descending sort, so routing and dispatch (the
priority's zeros included) match the reference's slot for slot.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import axis_index, psum
from .layers import ParamRng, activation

__all__ = ["init_moe", "moe_ffn", "moe_capacity"]


def init_moe(rng: ParamRng, cfg, dtype) -> dict:
    mo, D = cfg.moe, cfg.d_model
    E, Fe = mo.n_experts, mo.d_expert
    std_in = D ** -0.5
    # shared (always-on) experts live outside this dict: the transformer
    # computes them as a plain gated MLP
    return {
        "router": {"w": rng.normal((D, E), std_in, torch.float32)},
        "wi": rng.normal((E, D, Fe), std_in, dtype),
        "wg": rng.normal((E, D, Fe), std_in, dtype),
        "wo": rng.normal((E, Fe, D), Fe ** -0.5, dtype),
    }


def moe_capacity(cfg, n_tokens: int, n_shards: int = 1) -> int:
    """Static per-expert capacity for a local token count."""
    mo = cfg.moe
    per = n_tokens * mo.top_k / mo.n_experts
    return max(8, int(per * mo.capacity_factor + 0.999))


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, descending, equal
    values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: dict, x: torch.Tensor, cfg, *, axis_name=None,
            act: str = "silu", axis_data=None):
    """x: (..., T, D), flattened to (T, D) internally.  Returns (y,
    aux_loss).  ``axis_name`` / ``axis_data``: see the module docstring
    (an axis is ``(mesh, names)``); p's expert weights are then this
    rank's shards."""
    mo = cfg.moe
    lead = x.shape[:-1]
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    E = mo.n_experts
    E_loc = p["wi"].shape[0]
    n_shards = E // E_loc
    e0 = axis_index(axis_name) * E_loc if axis_name else 0

    # ---- routing (replicated compute on every expert rank)
    logits = xt.float() @ p["router"]["w"]                    # (T, E) fp32
    probs = torch.softmax(logits, -1)
    top_p, top_i = _top_k(probs, mo.top_k)                    # (T, k)
    if mo.norm_topk_prob:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    top_p = top_p * mo.router_scale

    # aux load-balance loss (Switch-style): E * sum_e f_e * P_e
    one_hot = F.one_hot(top_i, E).to(top_p.dtype)             # (T, k, E)
    f_e = one_hot.sum(1).mean(0)
    P_e = probs.mean(0)
    aux = E * torch.sum(f_e * P_e) * mo.aux_loss_coef

    # ---- capacity-bounded dispatch for the local experts
    C = moe_capacity(cfg, T, n_shards)
    local_oh = one_hot[..., e0:e0 + E_loc]                    # (T, k, E_loc)
    w_te = torch.einsum("tk,tke->te", top_p, local_oh)        # (T, E_loc)
    routed = w_te > 0
    # earliest-token priority: value (T - t) picks the first C per expert
    order = (T - torch.arange(T, device=x.device)).float()[None, :]
    prio = torch.where(routed.T, order, 0.0)                  # (E_loc, T)
    val, idx = _top_k(prio, min(C, T))                        # (E_loc, C)
    valid = val > 0
    gather_w = torch.take_along_dim(w_te.T, idx, 1) * valid  # (E_loc, C)

    xs = xt[idx.reshape(-1)].reshape(E_loc, -1, D) \
        * valid[..., None].to(xt.dtype)
    if axis_data:
        D_loc = p["wi"].shape[1]
        d0 = axis_index(axis_data) * D_loc
        xs_l = xs[..., d0:d0 + D_loc]
        # complete the D contraction over the data axes
        h = psum(torch.einsum("ecd,edf->ecf", xs_l, p["wi"].to(xt.dtype)),
                 axis_data)
        g = psum(torch.einsum("ecd,edf->ecf", xs_l, p["wg"].to(xt.dtype)),
                 axis_data)
    else:
        h = torch.einsum("ecd,edf->ecf", xs, p["wi"].to(xt.dtype))
        g = torch.einsum("ecd,edf->ecf", xs, p["wg"].to(xt.dtype))
    eo = torch.einsum("ecf,efd->ecd", activation(g, act) * h,
                      p["wo"].to(xt.dtype))
    eo = eo * gather_w[..., None].to(eo.dtype)
    D_out = eo.shape[-1]                     # D (1D path) or D_loc (2D)
    # invalid slots scatter a zero row at their index, as in the reference;
    # the sums land in a buffer made like eo (new_zeros), so under a fake
    # tensor mode carried by eo they are fake too
    y = eo.new_zeros((T, D_out)).index_add_(0, idx.reshape(-1),
                                            eo.reshape(-1, D_out))
    if axis_name:
        y = psum(y, axis_name)
    return y.reshape(*lead, D_out), aux
