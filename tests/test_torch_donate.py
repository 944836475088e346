"""Donated state in the port (``donate=True``): the train step, AdamW and
every serving step write their new state into the tensors they are given
and return those tensors, with the functional path's bits.

The reference's dry run donates the train state or the serving cache to
its jitted step; the port's steps do it on request.  Each case runs the
functional step and the donated step from equal copies of one state
(numpy-seeded batches, seed-0 weights) and holds:

- every output (losses, metrics, logits, tokens) and the final state of
  the donated run equal to the functional run's, bit for bit;
- every state tensor returned by the donated run the tensor it was given
  (its ``data_ptr``), and none by the functional run;

for ``adamw_update`` on a stacked leaf of the chunked path and on small
ones; three train steps of two smoke configs; prefill plus four decode
steps of olmo's smoke config, of every tensor-parallel mixer's
(``deepseek-v2-236b``: MLA, ``recurrentgemma-2b``: RG-LRU and a windowed
ring past its window, ``mamba2-780m``: SSD), and the cascade early-exit
decode step, on one device and on a one-rank gloo mesh (the mesh path:
DTensor caches written in their local shards).
"""

import shutil
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.early_exit import ExitConfig  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.serve import (make_cascade_decode_step,  # noqa: E402
                               make_decode_step, make_prefill_step)
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SERVE_ARCHS = ("olmo-1b", "deepseek-v2-236b", "recurrentgemma-2b",
               "mamba2-780m")
DECODE_STEPS = 4


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _ptrs(tree):
    """The storage address of every tensor of ``tree`` (a DTensor's local
    shard), 0-dim counters left out."""
    return [_local(t).data_ptr() for t in tree_leaves(tree) if t.dim()]


def _same_bits(a, b) -> bool:
    return all(torch.equal(_local(x), _local(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("chunk_min", [1 << 10, t_adamw.CHUNK_MIN_SIZE])
def test_donated_adamw_writes_the_functional_update_in_place(monkeypatch,
                                                             chunk_min):
    """A stacked (16, 8, 16) leaf: at ``chunk_min`` 2^10 it takes the
    chunked path (one dim-0 slice at a time), at the default size the
    direct one; a bias and a matrix beside it, clipped (norm > 1)."""
    monkeypatch.setattr(t_adamw, "CHUNK_MIN_SIZE", chunk_min)
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    params = {"stack": draw(16, 8, 16), "w": draw(8, 4), "b": draw(5)}
    grads = tree_map(lambda t: draw(*t.shape), params)
    state = t_adamw.AdamWState(
        torch.tensor(2, dtype=torch.int32),
        tree_map(lambda t: draw(*t.shape), params),
        tree_map(lambda t: draw(*t.shape).abs(), params))
    p1, s1, m1 = t_adamw.adamw_update(_clone(params), grads, state, 1e-2)
    given = (_clone(params), _clone(state.m), _clone(state.v))
    ptrs = _ptrs(given)
    p2, s2, m2 = t_adamw.adamw_update(
        given[0], grads, t_adamw.AdamWState(state.step, *given[1:]), 1e-2,
        donate=True)
    assert _same_bits((p1, s1.m, s1.v), (p2, s2.m, s2.v))
    assert torch.equal(s1.step, s2.step) and torch.equal(
        m1["grad_norm"], m2["grad_norm"])
    assert _ptrs((p2, s2.m, s2.v)) == ptrs
    assert all(a is b for a, b in zip(tree_leaves((p2, s2.m, s2.v)),
                                      tree_leaves(given)))
    assert not set(_ptrs((p1, s1.m, s1.v))) & set(ptrs)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-236b"])
def test_donated_train_steps_equal_the_functional_steps(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg, "cpu")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))} for _ in range(3)]
    runs = []
    for donate in (False, True):
        state = init_train_state(model, torch.Generator().manual_seed(0))
        ptrs = _ptrs((state.params, state.opt))
        step = make_train_step(model, peak_lr=1e-3, warmup=0, donate=donate)
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((state, metrics, _ptrs((state.params, state.opt)) ==
                     ptrs))
    (s1, m1, kept1), (s2, m2, kept2) = runs
    assert m1 == m2
    assert _same_bits((s1.params, s1.opt, s1.step),
                      (s2.params, s2.opt, s2.step))
    assert kept2 and not kept1


def _serve(model, params, prompt, donate: bool, cascade: bool = False):
    """Prefill and ``DECODE_STEPS`` greedy decode steps (the cascade
    early-exit step when ``cascade``): (logits and tokens of every step,
    the final cache, whether every step returned the given cache's
    tensors)."""
    cache = model.init_cache(prompt.shape[0], prompt.shape[1]
                             + DECODE_STEPS + 1)
    ptrs = _ptrs(cache)
    logits, cache = make_prefill_step(model, donate=donate)(params, prompt,
                                                            cache)
    kept = _ptrs(cache) == ptrs
    outs = [logits]
    if cascade:
        step = make_cascade_decode_step(
            model, ExitConfig((0,), (0.0,)), donate=donate)
    else:
        step = make_decode_step(model, donate=donate)
    tok = torch.argmax(_full(logits)[:, -1], -1).to(torch.int32)
    if hasattr(prompt, "device_mesh"):
        from torch.distributed.tensor import Replicate, distribute_tensor
        mesh = prompt.device_mesh
        tok = distribute_tensor(tok, mesh, [Replicate()] * mesh.ndim)
    for _ in range(DECODE_STEPS):
        tok, cache, third = step(params, tok, cache)
        outs += [tok, third]
        kept &= _ptrs(cache) == ptrs
    return [_full(t) for t in outs], cache, kept


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_donated_serving_equals_the_functional_steps(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    want, c1, kept1 = _serve(model, params, prompt, False)
    got, c2, kept2 = _serve(model, params, prompt, True)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert _same_bits(c1, c2)
    assert kept2 and not kept1


def test_donated_ring_cache_past_its_window():
    """RecurrentGemma's local attention keeps a ring of ``window`` entries:
    a prompt longer than the window takes the prefill's roll, then decode
    wraps around the ring."""
    cfg = get_smoke_config("recurrentgemma-2b")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, cfg.rglru.window + 7)))
    want, c1, _ = _serve(model, params, prompt, False)
    got, c2, kept = _serve(model, params, prompt, True)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert _same_bits(c1, c2) and kept


def test_donated_cascade_decode_equals_the_functional_step():
    cfg = get_smoke_config("olmo-1b").with_(n_layers=4)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 10)))
    want, c1, kept1 = _serve(model, params, prompt, False, cascade=True)
    got, c2, kept2 = _serve(model, params, prompt, True, cascade=True)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert _same_bits(c1, c2) and kept2 and not kept1


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank gloo process group in this process and its (1, 1) smoke
    mesh; destroyed after the module's tests."""
    from repro_torch.launch.mesh import make_smoke_mesh
    d = tempfile.mkdtemp(prefix="gloo_one_")
    dist.init_process_group("gloo", init_method=f"file://{d}/s",
                            world_size=1, rank=0)
    try:
        yield make_smoke_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_donated_mesh_serving_equals_the_functional_steps(one_rank_mesh,
                                                          arch):
    """The mesh path on one gloo rank: the caches are DTensors, the
    donated steps write their local shards; the functional run's bits,
    which at one rank are one device's."""
    from repro_torch.distributed.sharding import (batch_pspecs, distribute,
                                                  make_rules, param_pspecs)
    cfg = get_smoke_config(arch)
    rules = make_rules(one_rank_mesh)
    model = Model(cfg, "cpu", rules)
    one = Model(cfg, "cpu")
    params = one.init(torch.Generator().manual_seed(0))
    placed = distribute(params, param_pspecs(params, rules), one_rank_mesh)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    rows = distribute({"t": prompt}, batch_pspecs({"t": prompt}, rules),
                      one_rank_mesh)["t"]
    want, c1, kept1 = _serve(model, placed, rows, False)
    got, c2, kept2 = _serve(model, placed, rows, True)
    alone, _, _ = _serve(one, params, prompt, False)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert all(torch.equal(a, b) for a, b in zip(alone, got))
    assert _same_bits(c1, c2)
    assert kept2 and not kept1
