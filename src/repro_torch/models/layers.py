"""Shared neural layers: norms, RoPE, blockwise flash attention, gated MLPs.

Pure functions over explicit parameter dicts of tensors, as in the
reference: the stacked-layer walk in ``transformer.py`` treats parameters
as data.  Parameters are drawn by a :class:`ParamRng` (one
``torch.Generator`` on one device; shapes only on ``meta``).

Cast points follow the reference: ``dense`` is a same-dtype matmul (bf16
out in bf16 configs); attention scores and P·V accumulate in float32 (the
reference's ``preferred_element_type``), with the probabilities rounded to
the value dtype before P·V; norms and RoPE compute in float32 and cast
back.  A float32-accumulated product of low-precision operands is taken
as the float32 product of the operands upcast (exact for bf16 inputs).

``flash_attention`` is the reference's blockwise jnp attention (online
softmax over kv blocks of ``chunk_kv``, q blocks of ``chunk_q``, inputs
padded to chunk multiples) as a ``torch.autograd.Function``: the forward
keeps (q, k, v, o, lse) and the backward recomputes the probabilities
block by block (the reference's ``custom_vjp``).  Neither direction
materialises (S x Sk).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ParamRng", "mm32", "activation", "rmsnorm", "layernorm",
           "init_norm", "apply_norm", "rope_freqs", "apply_rope",
           "flash_attention", "attention_reference", "decode_attention",
           "gated_mlp", "init_gated_mlp", "init_dense", "dense", "NEG_INF",
           "write_into", "write_slot"]

NEG_INF = -1e30


class ParamRng:
    """Draws parameters in order from one generator on one device; on the
    ``meta`` device it makes shapes only (no generator, no memory)."""

    def __init__(self, device, generator: torch.Generator | None = None):
        self.device = torch.device(device)
        self.meta = self.device.type == "meta"
        if generator is None and not self.meta:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        """float32 N(0, std²) draws, cast to ``dtype``."""
        if self.meta:
            return torch.empty(shape, dtype=dtype, device="meta")
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return (x * std).to(dtype)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def tensor(self, values: np.ndarray, dtype) -> torch.Tensor:
        if self.meta:
            return torch.empty(values.shape, dtype=dtype, device="meta")
        return torch.as_tensor(values, dtype=dtype, device=self.device)


def mm32(a: torch.Tensor, b: torch.Tensor, spec: str) -> torch.Tensor:
    """``einsum(spec, a, b)`` accumulated and returned in float32."""
    return torch.einsum(spec, a.float(), b.float())


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU's silu or GeGLU's gelu (``jax.nn.gelu``'s tanh form)."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


# -------------------------------------------------------- donated caches
def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def write_into(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new``'s values written over ``buf`` in place (a DTensor's local
    shard, ``new`` placed as ``buf`` first); returns ``buf``.  Nothing is
    copied where ``new`` already is ``buf``'s memory (a writer that wrote
    in place)."""
    if hasattr(buf, "device_mesh") and hasattr(new, "device_mesh"):
        new = new.redistribute(buf.device_mesh, buf.placements)
    dst, src = _local(buf), _local(new)
    if not (dst.untyped_storage()._cdata == src.untyped_storage()._cdata
            and dst.storage_offset() == src.storage_offset()
            and dst.stride() == src.stride() and dst.shape == src.shape):
        dst.copy_(src)
    return buf


def write_slot(buf: torch.Tensor, x: torch.Tensor, slot: torch.Tensor,
               donate: bool = False, off: int | None = None) -> torch.Tensor:
    """x (B, 1, ...) written at position ``slot`` (a 0-dim integer
    tensor, in range) along axis 1 of ``buf``: a new tensor, or with
    ``donate`` ``buf`` itself, written in place.  With ``off``, ``buf``
    holds positions [off, off + its length) of a sequence split over
    ranks, and a slot outside them leaves ``buf`` as it was."""
    x = x.to(buf.dtype)
    if off is None:
        idx = slot.reshape(1).long()
        return (buf.index_copy_(1, idx, x) if donate
                else buf.index_copy(1, idx, x))
    rel = slot.reshape(1).long() - off
    tail = (1,) * (buf.dim() - 2)
    if not donate:
        hit = torch.arange(buf.shape[1], device=buf.device) == rel
        return torch.where(hit.reshape(1, -1, *tail), x, buf)
    # one slot rewritten: x where it is this rank's, else its old value
    idx = rel.clamp(0, buf.shape[1] - 1)
    x = torch.where((rel == idx).reshape(1, 1, *tail), x,
                    buf.index_select(1, idx))
    return buf.index_copy_(1, idx, x)


# --------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor | None,
              bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def init_norm(rng: ParamRng, kind: str, dim: int, dtype) -> dict:
    if kind == "rmsnorm":
        return {"scale": rng.full((dim,), 1.0, dtype)}
    if kind == "layernorm":
        return {"scale": rng.full((dim,), 1.0, dtype),
                "bias": rng.full((dim,), 0.0, dtype)}
    if kind == "layernorm_np":          # OLMo: non-parametric LN
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    if kind == "layernorm_np":
        return layernorm(x, None, None)
    raise ValueError(kind)


# ---------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, frac: float = 1.0) -> np.ndarray:
    """Inverse frequencies for the rotated prefix of the head dim."""
    rot = int(head_dim * frac) // 2 * 2
    return 1.0 / (theta ** (np.arange(0, rot, 2, np.float32) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               frac: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to x.shape[:-2].
    Rotate-half on the first ``int(D * frac) // 2 * 2`` dims."""
    d = x.shape[-1]
    rot = int(d * frac) // 2 * 2
    if rot == 0:
        return x
    inv = torch.from_numpy(rope_freqs(d, theta, frac)).to(x.device)
    ang = positions.float()[..., None] * inv                # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([out.to(x.dtype), x[..., rot:]], -1)


# ----------------------------------------------------------- flash attention
def _mask_block(q0, kv0, Tq, Tk, S, Sk, causal, window, device):
    """(Tq, Tk) bool validity mask for a (q-block, kv-block) pair."""
    qpos = q0 + torch.arange(Tq, device=device)[:, None]
    kpos = kv0 + torch.arange(Tk, device=device)[None, :]
    mask = (qpos < S) & (kpos < Sk)           # exclude padding
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def _blockwise_fwd(q, k, v, q0, S, Sk, causal, window, chunk_kv, scale):
    """Online softmax over kv blocks for one q block.

    q: (B, Tq, Hk, G, D); k/v: (B, Skp, Hk, D[v]).  Returns o (B, Hk, G,
    Tq, Dv) float32, normalised, and lse (B, Hk, G, Tq) float32.  A kv
    block that the causal or window mask hides from every row of the block
    is skipped: in the reference it leaves (o, m, l) bit for bit as they
    were (alpha = 1, p = 0).
    """
    B, Tq, Hk, G, D = q.shape
    Dv = v.shape[-1]
    dev = q.device
    # the buffers are made like q (new_*): in a fake tensor mode carried
    # by q they are fake too, as the reads and writes into them must be
    o = q.new_zeros((B, Hk, G, Tq, Dv), dtype=torch.float32)
    m = q.new_full((B, Hk, G, Tq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, Hk, G, Tq), dtype=torch.float32)
    qf = q.float()
    for kv0 in range(0, k.shape[1], chunk_kv):
        if _hidden(q0, Tq, kv0, chunk_kv, causal, window):
            continue
        ks = k[:, kv0:kv0 + chunk_kv].float()
        vs = v[:, kv0:kv0 + chunk_kv]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, ks) * scale
        mask = _mask_block(q0, kv0, Tq, chunk_kv, S, Sk, causal, window, dev)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # guard: rows with no valid key yet keep p = 0 (not exp(0))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = mm32(p.to(v.dtype), vs, "bhgqk,bkhd->bhgqd")
        o = o * alpha[..., None] + pv
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o / torch.clamp(l, min=1e-30)[..., None], lse


def _hidden(q0, Tq, kv0, Tk, causal, window) -> bool:
    """True when the causal or window mask hides the whole (q block, kv
    block) pair: its probabilities, and so its share of every output and
    gradient, are exactly zero."""
    if causal and kv0 > q0 + Tq - 1:
        return True
    return window is not None and q0 - (kv0 + Tk - 1) >= window


def _chunks(S, Sk, D, chunk_q, chunk_kv, softmax_scale):
    """(scale, cq, ckv, Sp, Skp): the blocks and the padded lengths."""
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    cq = min(chunk_q, S)
    ckv = min(chunk_kv, Sk)
    return scale, cq, ckv, -(-S // cq) * cq, -(-Sk // ckv) * ckv


def _pad_seq(x, n):
    """x (B, L, ...) zero-padded to length L + n along axis 1."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, n))


def _flash_fwd(q, k, v, causal, window, chunk_q, chunk_kv, softmax_scale):
    """(o (B, S, Hq, Dv) in q's dtype, lse (B, S, Hkv, G) float32)."""
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale, cq, ckv, Sp, Skp = _chunks(S, Sk, D, chunk_q, chunk_kv,
                                      softmax_scale)
    qp = _pad_seq(q, Sp - S)
    kp = _pad_seq(k, Skp - Sk)
    vp = _pad_seq(v, Skp - Sk)
    qg = qp.reshape(B, Sp // cq, cq, Hkv, G, D)
    o, lse = zip(*(_blockwise_fwd(qg[:, i], kp, vp, i * cq, S, Sk, causal,
                                  window, ckv, scale)
                   for i in range(Sp // cq)))
    # o: (B, nq, Hkv, G, cq, Dv) -> (B, Sp, Hq, Dv); lse likewise w/o Dv
    o = torch.stack(o, 1).permute(0, 1, 4, 2, 3, 5).reshape(
        B, Sp, Hq, Dv)[:, :S]
    lse = torch.stack(lse, 1).permute(0, 1, 4, 2, 3).reshape(
        B, Sp, Hkv, G)[:, :S]
    return o.to(q.dtype), lse


def _flash_bwd(q, k, v, o, lse, do, causal, window, chunk_q, chunk_kv,
               softmax_scale):
    """The reference's ``_flash_bwd``: (dq, dk, dv) in the inputs' dtypes.

    Blockwise over (kv block, q block), as the forward: ``p = exp(s -
    lse)`` under the mask, ``delta = rowsum(dO * O)`` and ``ds = p (dp -
    delta) scale`` in float32; ``p`` and ``ds`` are rounded to the operand
    dtype before their products, which accumulate in float32.  A pair the
    mask hides entirely is skipped (its share is exactly zero).
    """
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale, cq, ckv, Sp, Skp = _chunks(S, Sk, D, chunk_q, chunk_kv,
                                      softmax_scale)
    qp = _pad_seq(q, Sp - S).reshape(B, Sp, Hkv, G, D)
    dop = _pad_seq(do, Sp - S).reshape(B, Sp, Hkv, G, Dv)
    op = _pad_seq(o, Sp - S).reshape(B, Sp, Hkv, G, Dv)
    kp, vp = _pad_seq(k, Skp - Sk), _pad_seq(v, Skp - Sk)
    # per query, (B, Hkv, G, Sp) float32
    lsep = _pad_seq(lse, Sp - S).permute(0, 2, 3, 1)
    delta = torch.einsum("bshgd,bshgd->bhgs", dop.float(), op.float())
    # accumulated in place: made like q (new_zeros), so that under a fake
    # tensor mode carried by q the sums land in fake tensors, not in real
    # zeros the mode would copy and leave as they were
    dq = q.new_zeros((B, Sp, Hkv, G, D), dtype=torch.float32)
    dk = q.new_zeros((B, Skp, Hkv, D), dtype=torch.float32)
    dv = q.new_zeros((B, Skp, Hkv, Dv), dtype=torch.float32)
    for kv0 in range(0, Skp, ckv):
        ks, vs = kp[:, kv0:kv0 + ckv], vp[:, kv0:kv0 + ckv]
        for q0 in range(0, Sp, cq):
            if _hidden(q0, cq, kv0, ckv, causal, window):
                continue
            qs, dos = qp[:, q0:q0 + cq], dop[:, q0:q0 + cq]
            s = mm32(qs, ks, "bqhgd,bkhd->bhgqk") * scale
            mask = _mask_block(q0, kv0, cq, ckv, S, Sk, causal, window,
                               q.device)
            s = torch.where(mask, s, NEG_INF)
            p = torch.where(mask, torch.exp(
                s - lsep[..., q0:q0 + cq, None]), 0.0)
            dp = mm32(dos, vs, "bqhgd,bkhd->bhgqk")
            ds = p * (dp - delta[..., q0:q0 + cq, None]) * scale
            dv[:, kv0:kv0 + ckv] += mm32(p.to(do.dtype), dos,
                                         "bhgqk,bqhgd->bkhd")
            dk[:, kv0:kv0 + ckv] += mm32(ds.to(q.dtype), qs,
                                         "bhgqk,bqhgd->bkhd")
            dq[:, q0:q0 + cq] += mm32(ds.to(k.dtype), ks,
                                      "bhgqk,bkhd->bqhgd")
    return (dq.reshape(B, Sp, Hq, D)[:, :S].to(q.dtype),
            dk[:, :Sk].to(k.dtype), dv[:, :Sk].to(v.dtype))


class _Flash(torch.autograd.Function):
    """The forward and its residuals (q, k, v, o, lse); the backward
    through ``_flash_bwd``.  The five trailing arguments take no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk_q, chunk_kv,
                softmax_scale):
        o, lse = _flash_fwd(q, k, v, causal, window, chunk_q, chunk_kv,
                            softmax_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, chunk_q, chunk_kv, softmax_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    chunk_q: int = 512, chunk_kv: int = 1024,
                    softmax_scale: float | None = None) -> torch.Tensor:
    """Memory-efficient multi-head attention with GQA, differentiable in
    q, k and v.

    q: (B, S, Hq, D); k, v: (B, Sk, Hkv, D[v]) with Hq % Hkv == 0 and
    q/k positions aligned at 0 (training and prefill).  The live score
    block is (B, Hq, chunk_q, chunk_kv) float32.
    """
    return _Flash.apply(q, k, v, causal, window, chunk_q, chunk_kv,
                        softmax_scale)


def attention_reference(q, k, v, causal: bool = True,
                        window: int | None = None,
                        softmax_scale: float | None = None) -> torch.Tensor:
    """Naive O(S²) oracle (same GQA contract; supports Sk ≥ S with
    right-aligned queries)."""
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qf = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None] + (Sk - S)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, -1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, Hq, v.shape[-1]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, window=None,
                     softmax_scale=None) -> torch.Tensor:
    """Single-token attention over a (possibly longer, masked) cache.

    q: (B, 1, Hq, D); caches: (B, Smax, Hkv, D); ``cache_len``: (B,) or
    scalar count of valid entries (the new token's K/V already written).
    """
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    s = mm32(q.reshape(B, Hkv, G, D), k_cache, "bhgd,bkhd->bhgk") * scale
    pos = torch.arange(Smax, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).broadcast_to(
        (B,)).reshape(B, 1)
    mask = pos < clen
    if window is not None:
        mask &= pos >= clen - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, -1)
    o = mm32(p.to(v_cache.dtype), v_cache, "bhgk,bkhd->bhgd")
    return o.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)


# ----------------------------------------------------------------- MLP/dense
def init_dense(rng: ParamRng, d_in: int, d_out: int, dtype,
               bias: bool = False, scale: float | None = None) -> dict:
    std = scale if scale is not None else d_in ** -0.5
    p = {"w": rng.normal((d_in, d_out), std, dtype)}
    if bias:
        p["b"] = rng.full((d_out,), 0.0, dtype)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Same-dtype matmul (bf16 out for bf16 inputs), as the reference's."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def init_gated_mlp(rng: ParamRng, d_model: int, d_ff: int, dtype) -> dict:
    return {"wi": init_dense(rng, d_model, d_ff, dtype),
            "wg": init_dense(rng, d_model, d_ff, dtype),
            "wo": init_dense(rng, d_ff, d_model, dtype, scale=d_ff ** -0.5)}


def gated_mlp(p: dict, x: torch.Tensor, act: str = "silu",
              rules=None) -> torch.Tensor:
    g = dense(p["wg"], x)
    h = dense(p["wi"], x)
    if rules is not None:
        # the reference's pins of the hidden activation's TP layout (so
        # its cotangent keeps it too, and the backward's products stay
        # tensor-parallel)
        g = rules.act(g, "dp", None, "tp")
        h = rules.act(h, "dp", None, "tp")
    return dense(p["wo"], activation(g, act) * h)
