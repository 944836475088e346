"""The port's LM training path, the model half (``repro_torch.models``
backward, ``repro_torch.train``), on the CPU against the reference.

- the blockwise flash backward: dq, dk, dv against ``jax.grad`` through
  the reference's ``flash_attention`` at the reference's rtol 1e-3 / atol
  1e-4 (``tests/test_models.py``), and against autograd through the
  port's ``attention_reference``, over GQA, windows, lengths that are no
  chunk multiple and several q and kv blocks; one bf16 case, held to one
  bf16 rounding of each gradient (rtol 2**-7) past the float32 case's
  atol;
- the flash forward gives the bits of the forward-only version it
  replaced (a frozen copy below), with and without grad mode;
- ``cross_entropy_loss``: loss, metrics and d(loss)/d(logits) against the
  reference's at rtol 1e-6 / atol 1e-8 (the same float32 operations);
- microbatch accumulation equals the full batch at the reference's rtol
  2e-4 / atol 2e-5 (``tests/test_train.py``); remat changes no gradient
  bit; a step leaves its input state as it was;
- the reference's memorising-batch and compressed-training convergence
  tests on the port;
- serving parameters that require grad gives the tokens of their
  detached copies, and nothing served requires grad.

The per-architecture train steps are in ``test_torch_lm_train_archs.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models import layers as R  # noqa: E402
from repro.train.losses import cross_entropy_loss as r_ce  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.compression import make_compressor  # noqa: E402
from repro_torch.models import Model, layers as T  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import (generate, make_decode_step,  # noqa: E402
                               make_prefill_step)
from repro_torch.train import (cross_entropy_loss, init_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.train.train_step import batch_grads  # noqa: E402

FLASH_GRAD = dict(rtol=1e-3, atol=1e-4)


def draw(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def tokens_batch(vocab, B, S, seed=0):
    return {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32))}


# --------------------------------------------------------- flash backward
# (S, Hq, g, causal, window, chunk_q, chunk_kv): several q and kv blocks,
# lengths that are no chunk multiple, GQA g = 2, windows, non-causal
FLASH_BWD_CASES = [
    (17, 2, 1, True, None, 8, 8),
    (33, 4, 2, True, None, 16, 8),
    (50, 6, 2, True, 24, 16, 16),
    (71, 4, 1, True, 24, 32, 16),
    (45, 2, 2, False, None, 16, 32),
    (64, 4, 2, True, None, 64, 64),
]


def flash_inputs(s, hq, g, seed=10):
    hkv = hq // g
    return [draw(seed + i, 2, s, h, 16) for i, h in enumerate((hq, hkv, hkv))]


def port_grads(fn, arrays, do, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    fn(*ts).backward(torch.from_numpy(do).to(dtype))
    return [t.grad for t in ts]


@pytest.mark.parametrize("s,hq,g,causal,window,cq,ckv", FLASH_BWD_CASES)
def test_flash_backward_matches_reference(s, hq, g, causal, window, cq, ckv):
    arrays = flash_inputs(s, hq, g)
    do = draw(20, 2, s, hq, 16)

    def r_loss(q, k, v):
        return jnp.sum(R.flash_attention(q, k, v, causal, window, cq, ckv)
                       * do)

    want = jax.jit(jax.grad(r_loss, (0, 1, 2)))(*arrays)
    got = port_grads(lambda q, k, v: T.flash_attention(
        q, k, v, causal, window, cq, ckv), arrays, do)
    oracle = port_grads(lambda q, k, v: T.attention_reference(
        q, k, v, causal, window), arrays, do)
    for a, w, o in zip(got, want, oracle):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **FLASH_GRAD)
        np.testing.assert_allclose(a.numpy(), o.numpy(), **FLASH_GRAD)


def test_flash_backward_bf16_matches_reference():
    """bf16 operands: ``p`` and ``ds`` round to bf16 before their
    products, as in the reference; each gradient within one bf16 rounding
    of the reference's (rtol 2**-7) past the float32 atol."""
    s, hq, g, causal, window, cq, ckv = 50, 4, 2, True, 24, 16, 16
    arrays = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
              for a in flash_inputs(s, hq, g)]
    do = np.asarray(jnp.asarray(draw(21, 2, s, hq, 16)).astype(jnp.bfloat16),
                    np.float32)

    def r_loss(q, k, v):
        o = R.flash_attention(q, k, v, causal, window, cq, ckv)
        return jnp.sum(o.astype(jnp.float32) * do)

    want = jax.grad(r_loss, (0, 1, 2))(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays))
    got = port_grads(lambda q, k, v: T.flash_attention(
        q, k, v, causal, window, cq, ckv), arrays, do, torch.bfloat16)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=2 ** -7, atol=FLASH_GRAD["atol"])


def frozen_forward(q, k, v, causal, window, chunk_q, chunk_kv):
    """The blockwise flash forward as it was before it gained a backward
    (forward only, a frozen copy): the ``Function``'s forward must give
    its bits."""
    B, S, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    cq, ckv = min(chunk_q, S), min(chunk_kv, Sk)
    Sp, Skp = -(-S // cq) * cq, -(-Sk // ckv) * ckv
    qp = F.pad(q, (0, 0, 0, 0, 0, Sp - S))
    kp = F.pad(k, (0, 0, 0, 0, 0, Skp - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, Skp - Sk))
    qg = qp.reshape(B, Sp // cq, cq, Hkv, G, D)
    blocks = []
    for i in range(Sp // cq):
        q0, qf = i * cq, qg[:, i].float()
        o = torch.zeros((B, Hkv, G, cq, D))
        m = torch.full((B, Hkv, G, cq), T.NEG_INF)
        l = torch.zeros((B, Hkv, G, cq))
        for kv0 in range(0, Skp, ckv):
            if causal and kv0 > q0 + cq - 1:
                continue
            if window is not None and q0 - (kv0 + ckv - 1) >= window:
                continue
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                             kp[:, kv0:kv0 + ckv].float()) * scale
            mask = T._mask_block(q0, kv0, cq, ckv, S, Sk, causal, window,
                                 q.device)
            s = torch.where(mask, s, T.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = T.mm32(p.to(v.dtype), vp[:, kv0:kv0 + ckv],
                        "bhgqk,bkhd->bhgqd")
            o = o * alpha[..., None] + pv
            m = m_new
        blocks.append(o / torch.clamp(l, min=1e-30)[..., None])
    o = torch.stack(blocks, 1).permute(0, 1, 4, 2, 3, 5).reshape(
        B, Sp, Hq, D)[:, :S]
    return o.to(q.dtype)


@pytest.mark.parametrize("s,hq,g,causal,window,cq,ckv", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_bits_unchanged(s, hq, g, causal, window, cq, ckv,
                                      dtype):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in flash_inputs(s, hq, g))
    want = frozen_forward(q, k, v, causal, window, cq, ckv)
    with torch.no_grad():
        assert torch.equal(T.flash_attention(q, k, v, causal, window, cq,
                                             ckv), want)
    got = T.flash_attention(*(t.requires_grad_() for t in (q, k, v)),
                            causal, window, cq, ckv)
    assert got.requires_grad and torch.equal(got.detach(), want)


# ---------------------------------------------------------- cross entropy
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    logits = draw(30, 2, 5, 11, scale=3.0)
    labels = np.random.default_rng(31).integers(0, 11, (2, 5))
    mask = (np.random.default_rng(32).random((2, 5)) > 0.3).astype(
        np.float32) if masked else None

    def r_fn(lg):
        return r_ce(lg, jnp.asarray(labels),
                    None if mask is None else jnp.asarray(mask))

    (r_loss, r_m), r_g = jax.value_and_grad(r_fn, has_aux=True)(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    loss, m = cross_entropy_loss(lt, torch.from_numpy(labels),
                                 None if mask is None
                                 else torch.from_numpy(mask))
    loss.backward()
    tol = dict(rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), **tol)
    assert set(m) == set(r_m)
    for k in m:
        np.testing.assert_allclose(float(m[k].detach()), float(r_m[k]), **tol)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(r_g), **tol)


# ------------------------------------------- accumulation, remat, state
def test_grad_accumulation_matches_full_batch():
    model = Model(get_smoke_config("olmo-1b"), "cpu")
    state = init_train_state(model)
    batch = tokens_batch(model.cfg.vocab_size, 4, 16, seed=1)
    st1, m1 = make_train_step(model, peak_lr=1e-3, microbatch=0)(state,
                                                                 batch)
    st2, m2 = make_train_step(model, peak_lr=1e-3, microbatch=2)(state,
                                                                 batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    assert float(m1["tokens"]) == float(m2["tokens"]) == 4 * 16
    for a, b in zip(tree_leaves(st1.params), tree_leaves(st2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-236b",
                                  "recurrentgemma-2b"])
def test_remat_changes_no_gradient_bit(arch, monkeypatch):
    """``remat="block"`` recomputes each scan group (``checkpoint`` runs
    once per group under grad mode, never in prefill) and gives the
    gradients of ``remat="none"`` bit for bit."""
    cfg = get_smoke_config(arch)
    assert cfg.remat == "block"
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    on = Model(cfg, "cpu")
    off = Model(cfg.with_(remat="none"), "cpu")
    params = on.init()
    batch = tokens_batch(cfg.vocab_size, 2, 12, seed=2)
    g_on, m_on = batch_grads(on, params, batch)
    assert len(calls) == on.n_scan > 0
    g_off, m_off = batch_grads(off, params, batch)
    assert len(calls) == on.n_scan
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_on)
    on.prefill(params, batch["tokens"], on.init_cache(2, 16))
    assert len(calls) == on.n_scan


def test_step_leaves_its_input_state_unchanged():
    model = Model(get_smoke_config("olmo-1b"), "cpu")
    state = init_train_state(model)
    before = [t.clone() for t in tree_leaves(list(state))]
    new, metrics = make_train_step(model, peak_lr=1e-3, warmup=0)(
        state, tokens_batch(model.cfg.vocab_size, 2, 16))
    after = tree_leaves(list(state))
    assert all(torch.equal(a, b) and not b.requires_grad
               for a, b in zip(before, after))
    assert int(new.step) == 1 and int(new.opt.step) == 1
    assert new.step.dtype == torch.int32 and new.step.dim() == 0
    assert not any(torch.equal(a, b) for a, b in
                   zip(tree_leaves(state.params), tree_leaves(new.params))
                   if a.dim() >= 2)
    assert all(not v.requires_grad for v in metrics.values())


# ------------------------------------------------------------ convergence
def test_loss_decreases_memorizing_batch():
    model = Model(get_smoke_config("stablelm-1.6b"), "cpu")
    state = init_train_state(model)
    step = make_train_step(model, peak_lr=1e-3, warmup=3, total_steps=60)
    batch = tokens_batch(model.cfg.vocab_size, 4, 32, seed=3)
    first = None
    for _ in range(25):
        state, m = step(state, batch)
        first = first or float(m["loss"])
    assert float(m["loss"]) < first * 0.5


def test_compressed_training_still_converges():
    model = Model(get_smoke_config("olmo-1b"), "cpu")
    state = init_train_state(model)
    compress, _ = make_compressor()
    step = make_train_step(model, peak_lr=1e-3, warmup=3, total_steps=60,
                           compress_grads=compress)
    batch = tokens_batch(model.cfg.vocab_size, 4, 32, seed=4)
    first = None
    for _ in range(25):
        state, m = step(state, batch)
        first = first or float(m["loss"])
    assert float(m["loss"]) < first * 0.6


# ------------------------------------------------- serving a trained state
def test_serving_params_that_require_grad():
    model = Model(get_smoke_config("olmo-1b"), "cpu")
    state, _ = make_train_step(model, peak_lr=1e-3, warmup=3)(
        init_train_state(model), tokens_batch(model.cfg.vocab_size, 2, 16))
    live = tree_map(lambda t: t.clone().requires_grad_(), state.params)
    prompt = tokens_batch(model.cfg.vocab_size, 3, 9, seed=5)["tokens"]
    got = generate(model, live, prompt, max_new=6)
    assert torch.equal(got, generate(model, state.params, prompt, max_new=6))
    logits, cache = make_prefill_step(model)(live, prompt,
                                             model.init_cache(3, 16))
    nxt, cache, logits2 = make_decode_step(model)(live, got[:, 0], cache)
    outs = [logits, logits2, nxt, got] + tree_leaves(cache)
    assert not any(t.requires_grad for t in outs)
