"""The port's LM layers (``repro_torch.models.layers``) on the CPU against
the reference's (``repro.models.layers``) on the same seeded inputs.

- norms (rmsnorm, layernorm, OLMo's non-parametric layernorm), RoPE at
  ``frac`` 1.0 and 0.25 (stablelm's partial rotary), ``dense`` and
  ``gated_mlp`` (silu and tanh-gelu) in float32 at rtol 1e-5 / atol 1e-6
  (the same float32 operations, summed in another order);
- the blockwise flash forward against the reference's ``flash_attention``
  and against both packages' ``attention_reference`` at rtol 2e-4 / atol
  2e-5 (``tests/test_models.py``'s tolerance), on a fixed set of cases:
  odd lengths, GQA g = 2, a window of 24, non-causal; and
  ``attention_reference`` with right-aligned queries (Sk > S);
- ``decode_attention`` over a linear and a ring-buffer (windowed) cache;
- one bf16 case per function.  Measured on the CPU: the norms, RoPE,
  ``dense``, the flash forward and ``decode_attention`` give the
  reference's bf16 bits (max difference 0); they are held to one bf16
  rounding of the output (2**-7), where float32 values that differ in the
  last bits before the final cast could round apart.  ``gated_mlp`` in
  bf16 rounds four times before its last matmul (two dense outputs, the
  activation, the product; the packages round the activation's own
  steps differently), and its outputs differed by at most 2**-6, two
  bf16 ulps at 1: it is held to atol 2**-5, rtol 2**-6.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as R  # noqa: E402

from repro_torch.models import layers as T  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)
FLASH = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
BF16_MLP = dict(rtol=2 ** -6, atol=2 ** -5)
R_FLASH = jax.jit(R.flash_attention, static_argnums=(3, 4, 5, 6))
R_ORACLE = jax.jit(R.attention_reference, static_argnums=(3, 4))


def draw(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a reference array and a port tensor (bf16: both
    round the float32 values to nearest even, the same bits)."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.array(a)).to(getattr(torch, dtype)))


def close(got: torch.Tensor, want, tol: dict):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_np"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(kind, dtype):
    x_r, x_t = pair(draw(0, 3, 5, 64, scale=3.0) + 0.5, dtype)
    p_np = {"scale": draw(1, 64) + 1.0, "bias": draw(2, 64)}
    keys = {"rmsnorm": ["scale"], "layernorm": ["scale", "bias"],
            "layernorm_np": []}[kind]
    p_r = {k: pair(p_np[k], dtype)[0] for k in keys}
    p_t = {k: pair(p_np[k], dtype)[1] for k in keys}
    got = T.apply_norm(kind, p_t, x_t)
    assert got.dtype == x_t.dtype
    close(got, R.apply_norm(kind, p_r, x_r),
          F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("frac", [1.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(frac, dtype):
    x_r, x_t = pair(draw(3, 2, 37, 4, 32), dtype)
    pos = np.arange(37)[None, :] + 1000           # long positions too
    got = T.apply_rope(x_t, torch.from_numpy(pos), 10000.0, frac)
    want = R.apply_rope(x_r, jnp.asarray(pos), 10000.0, frac)
    np.testing.assert_array_equal(T.rope_freqs(32, 1e4, frac),
                                  R.rope_freqs(32, 1e4, frac))
    rot = int(32 * frac) // 2 * 2
    # the dims past the rotated prefix pass through untouched
    np.testing.assert_array_equal(got[..., rot:].float().numpy(),
                                  x_t[..., rot:].float().numpy())
    close(got, want, dict(rtol=1e-5, atol=2e-5) if dtype == "float32"
          else BF16)


# (S, Hq, g, causal, window, chunk): odd lengths, GQA g = 2, a window of 24,
# non-causal; chunks that split S and Sk into several padded blocks
FLASH_CASES = [
    (17, 2, 1, True, None, 32),
    (33, 4, 2, True, None, 16),
    (50, 6, 2, True, 24, 16),
    (71, 4, 1, True, 24, 32),
    (96, 6, 2, False, None, 32),
    (45, 2, 2, False, None, 16),
    (64, 4, 2, True, None, 64),
]


@pytest.mark.parametrize("s,hq,g,causal,window,chunk", FLASH_CASES)
def test_flash_forward_matches_reference(s, hq, g, causal, window, chunk):
    hkv = hq // g
    arrays = [draw(10 + i, 2, s, h, 16)
              for i, h in enumerate((hq, hkv, hkv))]
    (q_r, q_t), (k_r, k_t), (v_r, v_t) = (pair(a) for a in arrays)
    got = T.flash_attention(q_t, k_t, v_t, causal, window, chunk, chunk)
    close(got, R_FLASH(q_r, k_r, v_r, causal, window, chunk, chunk), FLASH)
    close(got, R_ORACLE(q_r, k_r, v_r, causal, window), FLASH)
    close(T.attention_reference(q_t, k_t, v_t, causal, window),
          R_ORACLE(q_r, k_r, v_r, causal, window), FLASH)


def test_flash_forward_bf16_and_right_aligned_oracle():
    arrays = [draw(20 + i, 1, 40, h, 16) for i, h in enumerate((4, 2, 2))]
    (q_r, q_t), (k_r, k_t), (v_r, v_t) = (pair(a, "bfloat16")
                                          for a in arrays)
    got = T.flash_attention(q_t, k_t, v_t, True, None, 16, 16)
    assert got.dtype == torch.bfloat16
    close(got, R_FLASH(q_r, k_r, v_r, True, None, 16, 16), BF16)
    # oracle with Sk > S: queries right-aligned to the last keys
    q2 = draw(23, 2, 5, 4, 16)
    (q2_r, q2_t) = pair(q2)
    (k_r, k_t), (v_r, v_t) = (pair(draw(24 + i, 2, 29, 2, 16))
                              for i in range(2))
    close(T.attention_reference(q2_t, k_t, v_t, True, 8),
          R_ORACLE(q2_r, k_r, v_r, True, 8), FLASH)


@pytest.mark.parametrize("window,cache_len", [(None, 13), (None, 32),
                                              (8, 13), (8, 5)])
def test_decode_attention_matches_reference(window, cache_len):
    q_r, q_t = pair(draw(30, 3, 1, 4, 16))
    (k_r, k_t), (v_r, v_t) = (pair(draw(31 + i, 3, 32, 2, 16))
                              for i in range(2))
    got = T.decode_attention(q_t, k_t, v_t, torch.tensor(cache_len),
                             window)
    close(got, R.decode_attention(q_r, k_r, v_r, cache_len, window), FLASH)
    # bf16 operands, float32 accumulation, bf16 out
    (q_r, q_t), (k_r, k_t), (v_r, v_t) = (
        pair(np.asarray(a, np.float32), "bfloat16")
        for a in (q_r, k_r, v_r))
    close(T.decode_attention(q_t, k_t, v_t, torch.tensor(cache_len), window),
          R.decode_attention(q_r, k_r, v_r, cache_len, window), BF16)


def test_decode_attention_ring_cache_through_attn_block():
    """A windowed layer's ring cache: the port's prefill keeps the last
    Smax positions rolled so slot (pos % Smax) holds pos, and decode
    writes there; logits of the block equal the reference's."""
    from repro.configs import get_smoke_config as r_cfg
    from repro.models import attn as r_attn
    from repro_torch.configs import get_smoke_config as t_cfg
    from repro_torch.models import attn as t_attn

    rc, tc = r_cfg("recurrentgemma-2b"), t_cfg("recurrentgemma-2b")
    window = rc.rglru.window                       # 32
    p_np = jax.tree.map(np.asarray, r_attn.init_attn(jax.random.key(1), rc,
                                                     jnp.float32))
    p_t = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
           for k, v in p_np.items()}
    B, S = 2, 45                                   # S > window: ring wraps
    x_r, x_t = pair(draw(40, B, S + 3, rc.d_model))
    rcache = r_attn.init_attn_cache(rc, B, 64, jnp.float32, window)
    tcache = t_attn.init_attn_cache(tc, B, 64, torch.float32, "cpu", window)
    out_r, rcache = r_attn.attn_block(p_np, x_r[:, :S], rc, window=window,
                                      cache=rcache)
    out_t, tcache = t_attn.attn_block(p_t, x_t[:, :S], tc, window=window,
                                      cache=tcache)
    close(out_t, out_r, FLASH)
    close(tcache["k"], rcache["k"], FLASH)
    for t in range(S, S + 3):
        out_r, rcache = r_attn.attn_block(p_np, x_r[:, t:t + 1], rc,
                                          window=window, cache=rcache,
                                          cache_len=jnp.int32(t))
        out_t, tcache = t_attn.attn_block(p_t, x_t[:, t:t + 1], tc,
                                          window=window, cache=tcache,
                                          cache_len=torch.tensor(t))
        close(out_t, out_r, FLASH)
        close(tcache["v"], rcache["v"], FLASH)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_gated_mlp_match_reference(act, dtype):
    x_r, x_t = pair(draw(50, 3, 7, 64), dtype)
    w = {n: draw(51 + i, *shape, scale=shape[0] ** -0.5)
         for i, (n, shape) in enumerate((("wi", (64, 96)), ("wg", (64, 96)),
                                         ("wo", (96, 64))))}
    p_r = {n: {"w": pair(a, dtype)[0]} for n, a in w.items()}
    p_t = {n: {"w": pair(a, dtype)[1]} for n, a in w.items()}
    b_r, b_t = pair(draw(55, 96), dtype)
    tol = F32 if dtype == "float32" else BF16
    got = T.dense({"w": p_t["wi"]["w"], "b": b_t}, x_t)
    assert got.dtype == x_t.dtype                  # same-dtype matmul
    close(got, R.dense({"w": p_r["wi"]["w"], "b": b_r}, x_r), tol)
    close(T.gated_mlp(p_t, x_t, act), R.gated_mlp(p_r, x_r, act),
          F32 if dtype == "float32" else BF16_MLP)
