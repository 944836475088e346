"""The port's training state (``repro_torch.optim``, ``data``,
``checkpoint``, ``distributed``, ``launch.train``) on the CPU against the
reference.

- ``adamw_update`` against the reference's on the same params and grads,
  clipped and not, over three steps, at rtol 1e-6 with an atol of 1e-6 of
  the leaf's largest |value| (unclipped: equal bits; clipped, the global
  norms, summed in another order, may differ in the last bit, and so may
  every scaled update, which an rtol alone cannot bound near zero);
  the streamed (chunked) update equals the direct one and leaves its
  inputs as they were; ``cosine_schedule`` within rtol 1e-6 (a few
  float32 ulps: the two libraries' float32 ``cos`` differ in the last bit
  for a few arguments);
- ``compress_leaf``'s q and scale equal the reference's (half-to-even
  rounding included); 50 error-feedback steps give equal outputs and
  feedback;
- ``SyntheticTokens`` / ``FileTokens`` batches equal the reference's, rank
  shares included;
- the reference's six checkpoint cases on the port; interchange: a
  reference-written ``TrainState`` (olmo smoke, after two steps)
  restores into the port bit for bit and its next step matches the
  reference's (metrics rtol 1e-5, params rtol 1e-6 / atol 1e-6); a
  port-written float32 state restores in the reference bit for bit; a
  reference-written bf16 leaf, which the reference itself cannot restore
  (its ``ValueError``), restores in the port;
- ``train_loop`` that fails mid-run under ``run_with_restarts`` ends with
  the metrics of an uninterrupted run; the entry points raise without a
  card unless ``"cpu"`` is named.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as r_ckpt  # noqa: E402
from repro import data as r_data  # noqa: E402
from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.distributed import compression as r_comp  # noqa: E402
from repro.models import build_model as r_build  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.train import init_train_state as r_init  # noqa: E402
from repro.train import make_train_step as r_make_step  # noqa: E402

from repro_torch.checkpoint import (latest_step, restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.checkpoint.checkpointer import _flatten  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import FileTokens, SyntheticTokens  # noqa: E402
from repro_torch.distributed import compression as t_comp  # noqa: E402
from repro_torch.distributed.fault import run_with_restarts  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

RNG = np.random.default_rng(0)


def np_of(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_trees_equal(a, b):
    """Leaves in the reference's flatten order, equal bit for bit."""
    la, lb = _flatten(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np_of(x), np.asarray(y))


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("clip", [False, True])
def test_adamw_matches_reference(clip):
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((4, 6)), "b": rng.standard_normal(6),
         "stack": [rng.standard_normal((8, 4, 5))]}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    pr = jax.tree.map(jnp.asarray, p)
    pt = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    sr, st = r_adamw.adamw_init(pr), t_adamw.adamw_init(pt)
    for i in range(3):
        scale = 3.0 if clip else 0.01
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                         .astype(np.float32), p)
        pr, sr, mr = r_adamw.adamw_update(pr, jax.tree.map(jnp.asarray, g),
                                          sr, 0.01)
        pt, st, mt = t_adamw.adamw_update(
            pt, jax.tree.map(lambda a: torch.from_numpy(a), g), st, 0.01)
        for got, want in ((pt, pr), (st.m, sr.m), (st.v, sr.v)):
            for x, y in zip(_flatten(got), jax.tree.leaves(want)):
                y = np.asarray(y)
                np.testing.assert_allclose(x.numpy(), y, rtol=1e-6,
                                           atol=1e-6 * np.abs(y).max())
        assert int(st.step) == int(sr.step) == i + 1
        assert st.step.dtype == torch.int32
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mr["grad_norm"]), rtol=1e-6)
        assert (float(mr["grad_norm"]) > 1.0) == clip


def test_adamw_chunked_update_matches_direct(monkeypatch):
    """Stacked-leaf streamed update == plain elementwise update; the
    inputs are left as they were."""
    big = torch.from_numpy(RNG.standard_normal((16, 32, 24)).astype(
        np.float32))
    g = torch.from_numpy(RNG.standard_normal(big.shape).astype(
        np.float32)) * 0.01
    st0 = t_adamw.adamw_init({"w": big})
    keep = big.clone()
    monkeypatch.setattr(t_adamw, "CHUNK_MIN_SIZE", 1)     # streamed path
    p_chunk, st1, _ = t_adamw.adamw_update({"w": big}, {"w": g}, st0, 0.01)
    monkeypatch.setattr(t_adamw, "CHUNK_MIN_SIZE", 1 << 60)   # direct path
    p_dir, st2, _ = t_adamw.adamw_update({"w": big}, {"w": g}, st0, 0.01)
    for a, b in ((p_chunk["w"], p_dir["w"]), (st1.m["w"], st2.m["w"]),
                 (st1.v["w"], st2.v["w"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert torch.equal(big, keep) and not st0.m["w"].any()
    assert p_chunk["w"].data_ptr() != big.data_ptr()


def test_cosine_schedule_matches_reference():
    for peak, warmup, total in ((1.0, 10, 100), (3e-4, 5, 37),
                                (1e-3, 0, 60)):
        for s in range(0, 130, 3):
            want = float(r_adamw.cosine_schedule(jnp.asarray(s, jnp.int32),
                                                 peak, warmup, total))
            got = t_adamw.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                          peak, warmup, total)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6)
            assert float(t_adamw.cosine_schedule(s, peak, warmup,
                                                 total)) == float(got)


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e3])
@pytest.mark.parametrize("shape", [(8,), (4, 5), (2, 3, 4)])
def test_compress_leaf_matches_reference(scale, shape):
    g = (RNG.standard_normal(shape) * scale).astype(np.float32)
    qr, sr = r_comp.compress_leaf(jnp.asarray(g))
    qt, st = t_comp.compress_leaf(torch.from_numpy(g))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    assert float(st) == float(sr)
    back = t_comp.decompress_leaf(qt, st)
    assert float((back - torch.from_numpy(g)).abs().max()) <= \
        float(st) * 0.5 + 1e-9


def test_compress_leaf_rounds_half_to_even():
    g = np.array([127, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5], np.float32)
    qt, _ = t_comp.compress_leaf(torch.from_numpy(g))
    qr, _ = r_comp.compress_leaf(jnp.asarray(g))
    np.testing.assert_array_equal(qt.numpy(), [127, 64, -64, 0, 0, 2, 2])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))


def test_error_feedback_matches_reference():
    c_r, ef_r = r_comp.make_compressor()
    c_t, ef_t = t_comp.make_compressor()
    true_sum = np.zeros((8, 8), np.float32)
    quant_sum = np.zeros((8, 8), np.float32)
    for _ in range(50):
        g = RNG.standard_normal((8, 8)).astype(np.float32)
        got = c_t({"w": torch.from_numpy(g)})["w"]
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(c_r({"w": jnp.asarray(g)})
                                                 ["w"]))
        true_sum += g
        quant_sum += got.numpy()
    np.testing.assert_array_equal(ef_t()["w"].numpy(),
                                  np.asarray(ef_r()["w"]))
    # all the bias lives in the feedback buffer
    assert np.abs(true_sum - quant_sum).max() <= \
        np.abs(ef_t()["w"].numpy()).max() + 1e-4


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("step,batch,seq,seed", [(0, 1, 2, 0), (7, 8, 16, 1),
                                                 (9999, 5, 63, 5)])
def test_synthetic_tokens_match_reference(step, batch, seq, seed):
    got = SyntheticTokens(1000, batch, seq, seed=seed)
    want = r_data.SyntheticTokens(1000, batch, seq, seed=seed)
    np.testing.assert_array_equal(got(step)["tokens"], want(step)["tokens"])
    assert got(step)["tokens"].shape == (batch, seq + 1)
    for world in (1, 3, 4):
        parts = [got.batch_at(step, rank=r, world=world)["tokens"]
                 for r in range(world)]
        for r, part in enumerate(parts):
            np.testing.assert_array_equal(
                part, want.batch_at(step, rank=r, world=world)["tokens"])
        np.testing.assert_array_equal(np.concatenate(parts, 0),
                                      got(step)["tokens"])


def test_file_tokens_match_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 5000, 100_000,
                                      dtype=np.int32).tofile(path)
    for vocab in (None, 1000):
        got = FileTokens(path, batch=4, seq_len=32, vocab_size=vocab)
        want = r_data.FileTokens(path, batch=4, seq_len=32,
                                 vocab_size=vocab)
        for step in (0, 3, 777):
            np.testing.assert_array_equal(got(step)["tokens"],
                                          want(step)["tokens"])
            for r in range(3):
                np.testing.assert_array_equal(
                    got.batch_at(step, rank=r, world=3)["tokens"],
                    want.batch_at(step, rank=r, world=3)["tokens"])
    assert got(3)["tokens"].shape == (4, 33)


# ------------------------------------------------------------- checkpoint
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((4, 8)).astype(
                np.float32)),
            "b": {"c": torch.from_numpy(rng.integers(0, 10, (3,)).astype(
                np.int32))}}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    t = _tree()
    save_checkpoint(d, 5, t, metadata={"loss": 1.25})
    got, step, meta = restore_checkpoint(d, t, device="cpu")
    assert step == 5 and meta["loss"] == 1.25
    for a, b in zip(_flatten(t), _flatten(got)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_partial_write_is_invisible(tmp_path):
    """A crashed writer (leftover .tmp dir) never corrupts restore."""
    d = str(tmp_path / "ckpt")
    t = _tree()
    save_checkpoint(d, 1, t)
    os.makedirs(os.path.join(d, "step_0000000002.tmp"))   # simulated crash
    with open(os.path.join(d, "step_0000000002.tmp", "leaf_0.npy"),
              "wb") as f:
        f.write(b"garbage")
    assert latest_step(d) == 1
    _, step, _ = restore_checkpoint(d, t, device="cpu")
    assert step == 1


def test_checkpoint_incomplete_final_dir_ignored(tmp_path):
    """A step dir without manifest (rename raced) is not 'latest'."""
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, _tree())
    os.makedirs(os.path.join(d, "step_0000000009"))     # no manifest inside
    assert latest_step(d) == 3


def test_checkpoint_prune_keeps_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, _tree(), keep=2)
    steps = sorted(int(n[5:]) for n in os.listdir(d)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    assert steps == [4, 5]


def test_checkpoint_structure_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _tree())
    with pytest.raises(ValueError):
        restore_checkpoint(d, {"a": torch.zeros((4, 8))}, device="cpu")
    with pytest.raises(ValueError):
        restore_checkpoint(d, {"a": torch.zeros((4, 9)),
                               "b": {"c": torch.zeros(3)}}, device="cpu")


def test_checkpoint_restore_casts_dtype(tmp_path):
    """float32 -> bf16 on restore rounds to nearest even, as the
    reference's cast does."""
    d = str(tmp_path / "ckpt")
    w = np.float32([1.0, 1.00390625, 1.01171875, -3.3, 7e-3])  # ties, not
    save_checkpoint(d, 1, {"w": torch.from_numpy(w)})
    got, _, _ = restore_checkpoint(
        d, {"w": torch.ones(5, dtype=torch.bfloat16)}, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(got["w"].float().numpy(), want)


@pytest.fixture(scope="module")
def olmo_states():
    """The reference's olmo smoke state after two steps, its third batch,
    and the port's model."""
    rm = r_build(r_smoke("olmo-1b"))
    step = jax.jit(r_make_step(rm, peak_lr=1e-3, warmup=0))
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, rm.cfg.vocab_size, (2, 17)).astype(np.int32)
               for _ in range(3)]
    state = r_init(rm, jax.random.key(0))
    for b in batches[:2]:
        state, _ = step(state, {"tokens": jnp.asarray(b)})
    return dict(r_state=state, r_step=step, batch=batches[2],
                model=Model(get_smoke_config("olmo-1b"), "cpu"))


def test_reference_train_state_restores_into_the_port(olmo_states, tmp_path):
    s = olmo_states
    d = str(tmp_path / "ref")
    r_ckpt.save_checkpoint(d, 2, s["r_state"])
    state, step, _ = restore_checkpoint(d, init_train_state(s["model"]),
                                        device="cpu")
    assert step == 2 and type(state).__name__ == "TrainState"
    assert_trees_equal(list(state), list(s["r_state"]))
    want_state, want = s["r_step"](s["r_state"],
                                   {"tokens": jnp.asarray(s["batch"])})
    got_state, got = make_train_step(s["model"], peak_lr=1e-3, warmup=0)(
        state, {"tokens": torch.from_numpy(s["batch"])})
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-5,
                                   err_msg=k)
    for x, y in zip(_flatten(got_state.params),
                    jax.tree.leaves(want_state.params)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)
    assert int(got_state.step) == int(want_state.step) == 3


def test_port_train_state_restores_in_the_reference(olmo_states, tmp_path):
    s = olmo_states
    state, _ = make_train_step(s["model"], peak_lr=1e-3, warmup=0)(
        init_train_state(s["model"]),
        {"tokens": torch.from_numpy(s["batch"])})
    d = str(tmp_path / "port")
    save_checkpoint(d, 1, state)
    got, step, _ = r_ckpt.restore_checkpoint(d, s["r_state"])
    assert step == 1
    assert_trees_equal(list(state), list(got))


def test_bf16_leaf_restores_in_the_port_not_the_reference(tmp_path):
    """Fault C5: the reference saves a bf16 leaf it cannot restore; the
    port restores its bits, and its own bf16 files alike."""
    w = jnp.asarray(RNG.standard_normal((2, 3)), jnp.float32).astype(
        jnp.bfloat16)
    d = str(tmp_path / "ref")
    r_ckpt.save_checkpoint(d, 1, {"w": w})
    with pytest.raises(ValueError):
        r_ckpt.restore_checkpoint(d, {"w": w})
    like = {"w": torch.zeros((2, 3), dtype=torch.bfloat16)}
    got, _, _ = restore_checkpoint(d, like, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(w, np.float32))
    d2 = str(tmp_path / "port")
    save_checkpoint(d2, 1, got)
    assert np.load(os.path.join(d2, "step_0000000001", "leaf_0.npy")).dtype \
        == np.load(os.path.join(d, "step_0000000001", "leaf_0.npy")).dtype
    again, _, _ = restore_checkpoint(d2, like, device="cpu")
    assert torch.equal(again["w"], got["w"])


# ----------------------------------------------------------------- launch
def test_train_loop_restart_ends_as_an_uninterrupted_run(tmp_path):
    cfg = get_smoke_config("olmo-1b")
    kw = dict(cfg=cfg, steps=6, batch=2, seq=16, lr=1e-3, ckpt_every=2,
              log_every=100, device="cpu")
    straight = train_loop(ckpt=str(tmp_path / "a"), **kw)
    restarts = []

    def loop(attempt):
        return train_loop(ckpt=str(tmp_path / "b"),
                          fail_at=3 if attempt == 0 else None, **kw)

    resumed = run_with_restarts(loop, on_restart=lambda a, e:
                                restarts.append(str(e)))
    assert restarts == ["injected failure at step 3"]
    assert resumed == straight and np.isfinite(resumed["loss"])
    assert latest_step(str(tmp_path / "b")) == 6


def test_entry_points_need_a_card_unless_cpu_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _tree())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(d, _tree())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(cfg=get_smoke_config("olmo-1b"), steps=1, batch=1, seq=4,
                   ckpt=None)
