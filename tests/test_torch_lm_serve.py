"""The port's LM serving (``repro_torch.serve.serve_step``,
``repro_torch.models.early_exit``) on the CPU against the reference's, on
``olmo-1b``'s smoke config cut to 6 layers (``tests/test_early_exit.py``'s
model), the reference's weights carried across.

- greedy ``generate`` gives the reference's tokens;
- the reference's three early-exit tests, run against the port;
- cascade decode steps give the reference's exit depths and tokens, step
  for step, under ``thresholds=(0.6, 0.5, 0.4)`` (every sequence exits at
  the first gate: the tied head of this random model is confident) and
  under thresholds between the exits' confidences, where depths differ
  across the batch;
- sampled ``generate`` is reproducible for a fixed seed (JAX's PRNG stream
  is not reproduced: the port draws from a ``torch.Generator``);
- ``Model(cfg)`` with no device raises on a host without a card.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.models import build_model as r_build  # noqa: E402
from repro.models import early_exit as r_ee  # noqa: E402
from repro.serve import generate as r_generate  # noqa: E402
from repro.serve import make_cascade_decode_step as r_cascade  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.models.early_exit import (ExitConfig,  # noqa: E402
                                           CascadeBatcher, expected_depth)
from repro_torch.serve import (generate, make_cascade_decode_step,  # noqa: E402
                               make_decode_step)

B, S = 4, 12


@pytest.fixture(scope="module")
def setup():
    """Both packages' model, the same weights, the same prompt prefilled."""
    rc = r_smoke("olmo-1b").with_(n_layers=6)
    rm = r_build(rc)
    rp = rm.init(jax.random.key(0))
    model = Model(get_smoke_config("olmo-1b").with_(n_layers=6), "cpu")
    params = params_from_reference(model.cfg, jax.tree.map(np.asarray, rp),
                                   "cpu")
    tokens = np.random.default_rng(0).integers(0, rc.vocab_size, (B, S))
    r_cache = rm.init_cache(B, 32)
    _, r_cache = jax.jit(rm.prefill)(rp, jnp.asarray(tokens), r_cache)
    cache = model.init_cache(B, 32)
    _, cache = model.prefill(params, torch.from_numpy(tokens), cache)
    return dict(rm=rm, rp=rp, r_cache=r_cache, model=model, params=params,
                tokens=tokens, cache=cache)


def test_generate_greedy_matches_reference(setup):
    got = generate(setup["model"], setup["params"],
                   torch.from_numpy(setup["tokens"]), max_new=8)
    want = r_generate(setup["rm"], setup["rp"], jnp.asarray(setup["tokens"]),
                      max_new=8)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_impossible_thresholds_match_plain_decode(setup):
    model, params = setup["model"], setup["params"]
    tokens, cache = torch.from_numpy(setup["tokens"]), setup["cache"]
    ecfg = ExitConfig(exit_groups=(1, 3), thresholds=(1.01, 1.01))
    t1, c1, depth = make_cascade_decode_step(model, ecfg)(
        params, tokens[:, -1], cache)
    t2, c2, _ = make_decode_step(model)(params, tokens[:, -1], cache)
    assert (depth.numpy() == model.n_scan).all()        # never exits
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())
    np.testing.assert_allclose(c1["scan"][0][0]["k"].numpy(),
                               c2["scan"][0][0]["k"].numpy(), rtol=1e-5)
    # the step wrote a copy: the prefilled cache is as it was
    assert int(cache["len"]) == S and int(c1["len"]) == S + 1


def test_zero_threshold_exits_first_gate(setup):
    ecfg = ExitConfig(exit_groups=(2,), thresholds=(0.0,))
    _, _, depth = make_cascade_decode_step(setup["model"], ecfg)(
        setup["params"], torch.from_numpy(setup["tokens"][:, -1]),
        setup["cache"])
    assert (depth.numpy() == 3).all()         # exits right after group 2


def test_batcher_buckets_by_depth():
    b = CascadeBatcher(n_groups=12, boundaries=(0.34, 0.67))
    for _ in range(8):
        b.observe("easy", 2.0)
        b.observe("hard", 12.0)
    assert b.bucket("easy") < b.bucket("hard")
    batches = b.batches(["easy", "hard"])
    assert ["easy"] in batches and ["hard"] in batches
    assert b.group_budget(b.bucket("easy")) < 12
    assert b.group_budget(b.bucket("hard")) == 12


@pytest.mark.parametrize("thresholds", [(0.6, 0.5, 0.4),
                                        (0.99999, 0.9999, 0.99)])
def test_exit_depths_match_reference(setup, thresholds):
    """Eight cascade steps from the same prefilled cache: each step's
    depths and tokens equal the reference's; the modelled saving too."""
    model, params = setup["model"], setup["params"]
    step = make_cascade_decode_step(model, ExitConfig((1, 3, 5), thresholds))
    r_step = jax.jit(r_cascade(setup["rm"], r_ee.ExitConfig((1, 3, 5),
                                                            thresholds)))
    tok = torch.from_numpy(setup["tokens"][:, -1])
    r_tok = jnp.asarray(setup["tokens"][:, -1])
    cache, r_cache = setup["cache"], setup["r_cache"]
    depths, r_depths = [], []
    batcher, r_batcher = CascadeBatcher(model.n_scan), \
        r_ee.CascadeBatcher(model.n_scan)
    for _ in range(8):
        tok, cache, depth = step(params, tok, cache)
        r_tok, r_cache, r_depth = r_step(setup["rp"], r_tok, r_cache)
        np.testing.assert_array_equal(depth.numpy(), np.asarray(r_depth))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(r_tok))
        depths.append(depth)
        r_depths.append(r_depth)
        for b in range(B):
            batcher.observe(b, float(depth[b]))
            r_batcher.observe(b, float(r_depth[b]))
    assert expected_depth(torch.stack(depths), model.n_scan) == \
        r_ee.expected_depth(jnp.stack(r_depths), model.n_scan)
    assert batcher.batches(list(range(B))) == \
        r_batcher.batches(list(range(B)))
    if thresholds[0] < 0.99:
        assert (torch.stack(depths) == 2).all()
    else:                              # a mix: some exit at 2, some run on
        assert len(torch.unique(torch.stack(depths))) > 1


def test_sampled_generate_reproducible(setup):
    run = [generate(setup["model"], setup["params"],
                    torch.from_numpy(setup["tokens"]), max_new=6,
                    sample=True, seed=s) for s in (7, 7, 8)]
    assert torch.equal(run[0], run[1])
    assert run[0].dtype == torch.int32 and run[0].shape == (B, 6)
    assert ((run[0] >= 0) & (run[0] < setup["model"].cfg.vocab_size)).all()
    # the first token is the prefill's greedy choice, the rest are drawn
    assert torch.equal(run[0][:, 0], run[2][:, 0])


def test_model_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_smoke_config("olmo-1b"))
    assert Model(get_smoke_config("olmo-1b"), "cpu").device.type == "cpu"
