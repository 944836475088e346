"""The port's LM blocks and counts (``repro_torch.models``) on the CPU
against the reference (``repro.models``).

- ``param_count`` (total and ``active_only``) equal to the reference's for
  every full config, without allocating (``meta`` device);
- MoE with capacity drops (``capacity_factor`` 1.0): outputs and aux loss
  equal to the reference's at rtol 1e-5 / atol 1e-6, the same experts
  taking the same tokens;
- MLA's absorbed decode against the reference's at atol 2e-3, including
  writes past the cache's end (the reference's ``dynamic_update_slice``
  clamps them to the last slot; the port clamps the same way);
- RG-LRU's doubling scan against the sequential recurrence at rtol 1e-5
  (``tests/test_models.py``'s tolerance), and SSD's chunked prefill
  against the port's own decode recurrence at atol 2e-3.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro import models as r_models  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import Model, param_count  # noqa: E402

from test_torch_lm_models import ATOL, carried, inputs  # noqa: E402


def test_param_counts_match_reference():
    for arch in r_configs.list_archs():
        rc, tc = r_configs.get_config(arch), t_configs.get_config(arch)
        total = r_models.param_count(rc)
        assert param_count(tc) == total and tc.n_params() == total, arch
        assert tc.n_active_params() == \
            r_models.param_count(rc, active_only=True), arch
    # olmo-1b, the card's full-width config: ~1.18 B parameters
    assert param_count(t_configs.get_config("olmo-1b")) == 1_176_764_416


def test_moe_capacity_drops_match_reference():
    from repro.models import moe as r_moe
    from repro_torch.models import moe as t_moe

    rc = r_configs.get_smoke_config("qwen3-moe-235b-a22b")
    rc = rc.with_(moe=replace(rc.moe, capacity_factor=1.0))
    tc = t_configs.get_smoke_config("qwen3-moe-235b-a22b")
    tc = tc.with_(moe=replace(tc.moe, capacity_factor=1.0))
    p_np = jax.tree.map(np.asarray, r_moe.init_moe(jax.random.key(0), rc,
                                                   jnp.float32))
    p_t = {k: ({"w": torch.tensor(v["w"])} if k == "router"
               else torch.tensor(v)) for k, v in p_np.items()}
    x = np.random.default_rng(0).standard_normal(
        (2, 64, rc.d_model)).astype(np.float32)
    y_r, aux_r = r_moe.moe_ffn(p_np, jnp.asarray(x), rc)
    y_t, aux_t = t_moe.moe_ffn(p_t, torch.from_numpy(x), tc)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-5)
    # the case drops tokens: some expert is routed more than its capacity
    T = 128
    probs = torch.softmax(torch.from_numpy(x.reshape(T, -1))
                          @ p_t["router"]["w"], -1)
    per_expert = torch.bincount(probs.topk(rc.moe.top_k).indices.reshape(-1),
                                minlength=rc.moe.n_experts)
    assert int(per_expert.max()) > t_moe.moe_capacity(tc, T)


def test_mla_absorbed_decode_matches_reference_past_cache_end():
    """Decode writes at ``cache_len``; past the cache's last slot both
    packages write the last slot (the clamp) and mask nothing out."""
    rm, rp, tm, tp = carried("deepseek-v2-236b")
    B, Sp, n, Smax = 2, 8, 6, 10              # cache_len 8..13 vs Smax 10
    tokens, _ = inputs(rm.cfg, B, Sp + n, seed=1)

    def ref_run(params, tokens):
        cache = rm.init_cache(B, Smax)
        _, cache = rm.prefill(params, tokens[:, :Sp], cache)
        out = []
        for t in range(Sp, Sp + n):
            lg, cache = rm.decode_step(params, tokens[:, t], cache)
            out.append(lg)
        return jnp.concatenate(out, 1), cache["prelude"][0]["ckv"]

    want, ckv_r = jax.jit(ref_run)(rp, jnp.asarray(tokens))
    tt = torch.from_numpy(tokens)
    cache = tm.init_cache(B, Smax)
    _, cache = tm.prefill(tp, tt[:, :Sp], cache)
    got = []
    for t in range(Sp, Sp + n):
        lg, cache = tm.decode_step(tp, tt[:, t], cache)
        got.append(lg)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(cache["prelude"][0]["ckv"].numpy(),
                               np.asarray(ckv_r), rtol=1e-5, atol=1e-6)
    # the absorbed decode inside the cache equals the decompressed forward
    full, _ = tm.forward(tp, tt[:, :Smax])
    np.testing.assert_allclose(torch.cat(got[:Smax - Sp], 1).numpy(),
                               full[:, Sp:Smax].numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_sequential(with_h0):
    from repro_torch.models.rglru import _rglru_scan
    rng = np.random.default_rng(0)
    B, S, W = 2, 33, 8
    log_a = -np.abs(rng.standard_normal((B, S, W))).astype(np.float32) * 0.3
    bx = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32) if with_h0 else None
    hs = _rglru_scan(torch.from_numpy(log_a), torch.from_numpy(bx),
                     None if h0 is None else torch.from_numpy(h0)).numpy()
    h = np.zeros((B, W)) if h0 is None else h0.astype(np.float64)
    for t in range(S):
        h = np.exp(log_a[:, t].astype(np.float64)) * h + bx[:, t]
        np.testing.assert_allclose(hs[:, t], h, rtol=1e-5, atol=1e-5)


def test_ssd_chunked_prefill_matches_decode_recurrence():
    """The port's chunked SSD (3 chunks of 16 here, one padded) == its
    step-by-step recurrence."""
    cfg = t_configs.get_smoke_config("mamba2-780m")
    m = Model(cfg, "cpu")
    p = m.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(inputs(cfg, 1, 40)[0])
    full, _ = m.forward(p, tokens)
    cache = m.init_cache(1, 44)
    lg, cache = m.prefill(p, tokens[:, :1], cache)
    errs = [float((lg[:, 0] - full[:, 0]).abs().max())]
    for t in range(1, 40):
        lg, cache = m.decode_step(p, tokens[:, t], cache)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < ATOL, errs
