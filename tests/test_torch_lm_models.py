"""The port's LM models (``repro_torch.models``) on the CPU against the
reference (``repro.models``), with the reference's weights carried across
(``params_from_reference``): every architecture's smoke config,
``forward`` logits, then ``prefill`` of 12 tokens and 4 ``decode_step``s,
against the reference's (jitted) at atol 2e-3, the reference's own decode
tolerance (``tests/test_models.py``); ``Model.init``'s shapes, dtypes and
seed.  The block-level checks are in ``test_torch_lm_blocks.py``.
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
from repro_torch.models import Model, params_from_reference  # noqa: E402

ATOL = 2e-3
N_DECODE = 4


def nodrop(cfg):
    if cfg.moe is not None:
        return cfg.with_(moe=replace(cfg.moe, capacity_factor=16.0))
    return cfg


def carried(arch, edit=nodrop):
    """(reference model, its params, port model, the same params)."""
    rc = edit(r_configs.get_smoke_config(arch))
    tc = edit(t_configs.get_smoke_config(arch))
    rm = r_models.build_model(rc)
    rp = rm.init(jax.random.key(0))
    tm = Model(tc, "cpu")
    return rm, rp, tm, params_from_reference(tc, jax.tree.map(np.asarray, rp),
                                             "cpu")


def inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    prefix = None
    if cfg.input_mode == "tokens+prefix":
        prefix = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return tokens, prefix


@pytest.mark.parametrize("arch", r_configs.list_archs())
def test_forward_prefill_decode_match_reference(arch):
    rm, rp, tm, tp = carried(arch)
    B, Sp = 2, 12
    S = Sp + N_DECODE
    tokens, prefix = inputs(rm.cfg, B, S)
    kw_r = {} if prefix is None else {"prefix_embeds": jnp.asarray(prefix)}
    kw_t = {} if prefix is None else {
        "prefix_embeds": torch.from_numpy(prefix)}

    def ref_run(params, tokens, **kw):
        full, _ = rm.forward(params, tokens, **kw)
        cache = rm.init_cache(B, 32)
        lg, cache = rm.prefill(params, tokens[:, :Sp], cache, **kw)
        steps = [lg]
        for t in range(Sp, S):
            lg, cache = rm.decode_step(params, tokens[:, t], cache)
            steps.append(lg)
        return full, jnp.concatenate(steps, 1)

    full_r, steps_r = jax.jit(ref_run)(rp, jnp.asarray(tokens), **kw_r)

    tt = torch.from_numpy(tokens)
    full_t, aux = tm.forward(tp, tt, **kw_t)
    assert full_t.dtype == torch.float32 and bool(torch.isfinite(aux))
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_r), rtol=0,
                               atol=ATOL)
    cache = tm.init_cache(B, 32)
    lg, cache = tm.prefill(tp, tt[:, :Sp], cache, **kw_t)
    steps = [lg]
    for t in range(Sp, S):
        lg, cache = tm.decode_step(tp, tt[:, t], cache)
        steps.append(lg)
    assert int(cache["len"]) == S + (0 if prefix is None else prefix.shape[1])
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                               np.asarray(steps_r), rtol=0, atol=ATOL)


def test_init_shapes_and_seed():
    """``Model.init`` draws the reference's shapes and dtypes, from its
    generator: the same seed gives the same parameters."""
    cfg = t_configs.get_smoke_config("deepseek-v2-236b")
    m = Model(cfg, "cpu")
    a = m.init(torch.Generator().manual_seed(3))
    b = m.init(torch.Generator().manual_seed(3))
    c = m.init(torch.Generator().manual_seed(4))
    rp = jax.tree.map(np.asarray, r_models.build_model(
        r_configs.get_smoke_config("deepseek-v2-236b")).init(
            jax.random.key(0)))
    got = params_from_reference(cfg, rp, "cpu")     # raises on a mismatch
    emb = "embed", "embedding"
    assert torch.equal(a[emb[0]][emb[1]], b[emb[0]][emb[1]])
    assert not torch.equal(a[emb[0]][emb[1]], c[emb[0]][emb[1]])
    assert a[emb[0]][emb[1]].shape == got[emb[0]][emb[1]].shape
    with pytest.raises(ValueError):
        params_from_reference(cfg, {**rp, "final_norm": {"x": np.ones(1)}},
                              "cpu")
