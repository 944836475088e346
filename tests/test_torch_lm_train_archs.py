"""One train step of every architecture's smoke config on the port
(``repro_torch.train``) against the reference's (``repro.train``), the
reference's weights carried across (``params_from_reference``), MoE
capacity drops off (a routing flip would dominate the comparison):

- every gradient leaf against the reference's ``jax.value_and_grad`` of
  the same loss, within 1e-4 of the leaf's largest |g| (float32, summed
  in another order through a few layers), and finite;
- the step's metrics (loss, nll, z_loss, accuracy, tokens, aux_loss,
  grad_norm, lr) at rtol 1e-5.

musicgen takes ``embeddings`` inputs and internvl ``tokens+prefix``,
whose prefix logits the loss slices off.  One jitted reference program
per architecture computes both the gradients and the step.
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
from repro.train import init_train_state as r_init  # noqa: E402
from repro.train import make_train_step as r_make_step  # noqa: E402
from repro.train.losses import cross_entropy_loss as r_ce  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402
from repro_torch.train.train_step import batch_grads  # noqa: E402

GRAD_REL = 1e-4
METRIC_RTOL = 1e-5
B, S = 2, 17
STEP = dict(peak_lr=1e-3, warmup=0)


def nodrop(cfg):
    if cfg.moe is not None:
        return cfg.with_(moe=replace(cfg.moe, capacity_factor=16.0))
    return cfg


def make_batch(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, S + 1)).astype(np.int32)}
    if cfg.input_mode == "tokens+prefix":
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    elif cfg.input_mode == "embeddings":
        batch["prefix_embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", r_configs.list_archs())
def test_train_step_matches_reference(arch):
    rc = nodrop(r_configs.get_smoke_config(arch))
    tc = nodrop(t_configs.get_smoke_config(arch))
    rm = r_models.build_model(rc)
    r_state = r_init(rm, jax.random.key(0))
    batch = make_batch(rc)

    def r_loss(params, b):
        kw = ({"prefix_embeds": b["prefix_embeds"]}
              if "prefix_embeds" in b else {})
        logits, aux = rm.forward(params, b["tokens"][:, :-1], **kw)
        if rc.input_mode == "tokens+prefix":
            logits = logits[:, rc.n_prefix_embeds:]
        loss, _ = r_ce(logits, b["tokens"][:, 1:], None)
        return loss + aux

    r_step = r_make_step(rm, **STEP)

    @jax.jit
    def reference(state, b):
        return jax.grad(r_loss)(state.params, b), r_step(state, b)[1]

    r_grads, r_metrics = reference(r_state,
                                   jax.tree.map(jnp.asarray, batch))

    model = Model(tc, "cpu")
    params = params_from_reference(
        tc, jax.tree.map(np.asarray, r_state.params), "cpu")
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, _ = batch_grads(model, params, t_batch)
    state = TrainState(params, adamw_init(params),
                       torch.zeros((), dtype=torch.int32))
    _, metrics = make_train_step(model, **STEP)(state, t_batch)

    want = jax.tree.leaves(r_grads)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())
    assert set(metrics) == set(r_metrics)
    for k, w in r_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(w),
                                   rtol=METRIC_RTOL, err_msg=k)
