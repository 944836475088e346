"""The port's mesh paths on real multi-rank gloo meshes (CPU), against the
reference.

Three worlds are spawned (each rank one process, one intra-op thread, a
time limit on every world); each runs several cases and rank 0 hands its
results back to the test process, which holds them against the
reference's numbers:

- world A, (2, 4) = ("data", "model") and an 8-rank axis: an olmo smoke
  train step and a GQA smoke step (llama3: 8 q heads, 2 kv heads, tp 4)
  from the reference's own initial weights, against its single-device
  jitted step, at the reference's sharded-test bounds (|dloss| < 1e-4,
  params within 5e-3; the grad norm and the AdamW moments, which carry
  the gradients), placements kept; qwen3-moe smoke (capacity 16)
  forward on the mesh (1D ``shard_map``), its 2D decode form and decode
  steps against the reference's local forward and decode; MLA, RG-LRU
  and SSD serving on the mesh against one device; greedy
  ``generate`` on the mesh equal to one device's tokens; every smoke
  architecture's gradients on the mesh against one device's;
  ``compressed_psum`` over the 8-rank axis; a stablelm smoke checkpoint
  saved from the mesh;
- world B, (4, 2): the reference's (2, 4) checkpoint (written by a
  subprocess with 8 XLA host devices, as the reference's elastic test
  does) and world A's checkpoint restored with ``shardings=``, each rank
  reading its shards; a save of leaves sharded unevenly and over two
  axes, each rank writing its shards;
- world C, (2, 2): ``train_loop(mesh=)`` failing once and resumed by
  ``run_with_restarts``, against an uninterrupted one-device run.

Gloo's sums across ranks add in another order than one device's, so
these hold the reference's tolerances; bit equality is for one rank
(``tests/test_torch_cuda.py`` on the card) and for ``compressed_psum``,
whose sums are exact integers.
"""

import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD_TIMEOUT = 300
OLMO_TOKENS = (4, 33)
MOE_TOKENS = (4, 16)
PROMPT = (4, 12)
DECODE_STEPS = 3
LOSS_TOL, PARAM_TOL = 1e-4, 5e-3          # tests/test_distributed.py:77-78
MOE_ERR, AUX_ERR = 5e-4, 5e-3             # tests/test_distributed.py:111-114
LOGIT_ATOL = 2e-3                         # test_torch_lm_models.py's bound
UNEVEN_HEADS = 5
TRAIN_LOOP = dict(steps=6, batch=4, seq=16, lr=1e-3, ckpt_every=2,
                  log_every=100)


# ------------------------------------------------------------ the worlds
def _run_world(fn, nprocs: int, *args):
    """Spawn ``nprocs`` ranks of ``fn(rank, nprocs, store, *args)``; a rank
    that raises fails the call, one that hangs is killed at the limit."""
    store = tempfile.mkdtemp(prefix="gloo_")
    ctx = mp.start_processes(fn, args=(nprocs, store) + args, nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.time() + WORLD_TIMEOUT
    while not ctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a {nprocs}-rank world passed "
                               f"{WORLD_TIMEOUT} s")


def _init(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}/s",
                            world_size=world, rank=rank)


def _sharded(model, tree):
    from repro_torch.distributed.sharding import distribute, param_pspecs
    return distribute(tree, param_pspecs(tree, model.rules),
                      model.rules.mesh)


def _rows(tree, rules):
    from repro_torch.distributed.sharding import batch_pspecs, distribute
    return distribute(tree, batch_pspecs(tree, rules), rules.mesh)


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()


def _step_case(rules, arch, init, tokens):
    """One train step on the mesh from the reference's initial weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model, params_from_reference
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_leaves
    from repro_torch.checkpoint.checkpointer import _flatten
    cfg = get_smoke_config(arch)
    model = Model(cfg, "cpu", rules)
    params = _sharded(model, params_from_reference(cfg, init, "cpu"))
    state = TrainState(params, adamw_init(params),
                       torch.zeros((), dtype=torch.int32))
    new, met = make_train_step(model, peak_lr=1e-3)(
        state, _rows({"tokens": torch.from_numpy(tokens)}, rules))
    kept = all(a.placements == b.placements == c.placements
               for a, b, c in zip(tree_leaves(params),
                                  tree_leaves(new.params),
                                  tree_leaves(new.opt.m)))
    return {"loss": float(met["loss"]), "kept": kept,
            "grad_norm": float(met["grad_norm"]),
            # in the reference's leaf order (dict keys sorted)
            "params": [_full(t) for t in _flatten(new.params)],
            "m": [_full(t) for t in _flatten(new.opt.m)],
            "v": [_full(t) for t in _flatten(new.opt.v)]}


def _moe_case(rules, init, tokens, prompt, x2d):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model, params_from_reference
    from repro_torch.distributed.sharding import placements
    from torch.distributed.tensor import Replicate, distribute_tensor
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    cfg = cfg.with_(moe=replace(cfg.moe, capacity_factor=16.0))
    model = Model(cfg, "cpu", rules)
    p = _sharded(model, params_from_reference(cfg, init, "cpu"))
    logits, aux = model.forward(p, _rows({"t": torch.from_numpy(tokens)},
                                         rules)["t"])
    out = {"logits": _full(logits), "aux": float(aux)}
    layer = {k: ({"w": v["w"][0]} if k == "router" else v[0])
             for k, v in p["scan"][0]["ffn"]["moe"].items()}
    mesh = rules.mesh
    x = distribute_tensor(torch.from_numpy(x2d), mesh,
                          placements(rules.spec(None, None, "dp"), mesh))
    y, aux2 = model._moe(layer, x, decode2d=True)
    out.update(y2d=_full(y), aux2d=float(aux2))
    cache = model.init_cache(prompt.shape[0], prompt.shape[1]
                             + DECODE_STEPS)
    lg, cache = model.prefill(p, _rows({"t": torch.from_numpy(prompt)},
                                       rules)["t"], cache)
    steps = [_full(lg)]
    tok = distribute_tensor(torch.from_numpy(np.argmax(steps[0][:, -1], -1)),
                            mesh, [Replicate()] * mesh.ndim)
    for _ in range(DECODE_STEPS):
        lg, cache = model.decode_step(p, tok, cache)
        steps.append(_full(lg))
        tok = distribute_tensor(torch.from_numpy(np.argmax(
            steps[-1][:, -1], -1)), mesh, [Replicate()] * mesh.ndim)
    out["decode"] = steps
    return out


def _generate_case(rules, prompt):
    """Greedy ``generate`` of the olmo smoke model (seed-0 weights) on the
    mesh and on one device."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.serve import generate
    cfg = get_smoke_config("olmo-1b")
    one = Model(cfg, "cpu")
    params = one.init(torch.Generator().manual_seed(0))
    want = generate(one, params, torch.from_numpy(prompt), max_new=6)
    sharded = Model(cfg, "cpu", rules)
    got = generate(sharded, _sharded(sharded, params),
                   _rows({"t": torch.from_numpy(prompt)}, rules)["t"],
                   max_new=6)
    return {"want": want.numpy(), "got": _full(got)}


SERVE_ARCHS = ("deepseek-v2-236b", "recurrentgemma-2b", "mamba2-780m")


def _serve_archs_case(rules, prompt):
    """MLA, RG-LRU and SSD serving on the mesh and on one device (seed-0
    weights, MoE capacity drops off): prefill and ``DECODE_STEPS`` decode
    steps' logits, the caches' length a multiple of tp so the latent
    cache's sequence is split over it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = rules.mesh
    out = {}
    for arch in SERVE_ARCHS:
        cfg = get_smoke_config(arch)
        if cfg.moe is not None:
            cfg = cfg.with_(moe=replace(cfg.moe, capacity_factor=16.0))
        one, sharded = Model(cfg, "cpu"), Model(cfg, "cpu", rules)
        params = one.init(torch.Generator().manual_seed(0))
        runs, fed = [], []             # both fed one device's tokens
        for model, p, tok in (
                (one, params, torch.from_numpy(prompt)),
                (sharded, _sharded(sharded, params),
                 _rows({"t": torch.from_numpy(prompt)}, rules)["t"])):
            cache = model.init_cache(prompt.shape[0],
                                     prompt.shape[1] + DECODE_STEPS + 1)
            lg, cache = model.prefill(p, tok, cache)
            steps = [_full(lg)]
            for i in range(DECODE_STEPS):
                if model is one:
                    fed.append(torch.from_numpy(np.argmax(
                        steps[-1][:, -1], -1)))
                nxt = fed[i]
                if model is sharded:
                    nxt = distribute_tensor(nxt, mesh,
                                            [Replicate()] * mesh.ndim)
                lg, cache = model.decode_step(p, nxt, cache)
                steps.append(_full(lg))
            runs.append(steps)
        out[arch] = max(float(np.abs(a - b).max())
                        for a, b in zip(*runs))
    return out


DONATE_ARCHS = ("olmo-1b", "deepseek-v2-236b")
DONATE_CACHE = 16


def _donate_case(rules, prompt):
    """Prefill and decode on the mesh with ``donate=True`` and without,
    for olmo (a KV cache) and deepseek (MLA's latent cache), both with
    their sequence split over tp (16 positions, 4 per rank): a 6-token
    prompt and 6 decode steps (the prompt spans two ranks' chunks, the
    steps write into two), and a 16-token prompt (the dry run's prefill
    cells: the prompt fills the cache).  Per case: the entries of the
    logits and the final cache that differ between the two runs, and
    whether the donated run's cache tensors kept their local storage.
    Also the peak extra bytes of writing a 16-token prompt replicated
    over tp into MLA's cache in place (``write_prompt_mesh``, counted by
    ``LocalCost``), beside one cache leaf's local bytes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import distribute, placements
    from repro_torch.launch.roofline import LocalCost
    from repro_torch.models import Model
    from repro_torch.models.attn import write_prompt_mesh
    from repro_torch.tree import tree_leaves
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = rules.mesh
    out = {}
    for arch in DONATE_ARCHS:
        cfg = get_smoke_config(arch)
        if cfg.moe is not None:
            cfg = cfg.with_(moe=replace(cfg.moe, capacity_factor=16.0))
        model = Model(cfg, "cpu", rules)
        params = _sharded(model, model.init(torch.Generator().manual_seed(0)))
        for S, steps in ((6, 6), (DONATE_CACHE, 0)):
            tokens = np.resize(prompt, (prompt.shape[0], S))
            runs = []
            for donate in (False, True):
                cache = model.init_cache(prompt.shape[0], DONATE_CACHE)
                held = [t for t in tree_leaves(cache) if t.dim() > 0]
                ptrs = [t.to_local().data_ptr() for t in held]
                lg, new = model.prefill(
                    params, _rows({"t": torch.from_numpy(tokens)},
                                  rules)["t"], cache, donate=donate)
                logits = [_full(lg)]
                for _ in range(steps):
                    nxt = distribute_tensor(
                        torch.from_numpy(logits[-1][:, -1].argmax(-1)),
                        mesh, [Replicate()] * mesh.ndim)
                    lg, new = model.decode_step(params, nxt, new,
                                                donate=donate)
                    logits.append(_full(lg))
                mine = [t for t in tree_leaves(new) if t.dim() > 0]
                runs.append((logits + [_full(t) for t in mine],
                             all(a is b and a.to_local().data_ptr() == p
                                 for a, b, p in zip(held, mine, ptrs))))
            (plain, _), (donated, aliased) = runs
            out[(arch, S)] = {
                "differ": sum(int((a != b).sum())
                              for a, b in zip(plain, donated)),
                "entries": sum(a.size for a in plain),
                "aliased": aliased}
    cfg = get_smoke_config("deepseek-v2-236b")
    cache = Model(cfg, "cpu", rules).init_cache(prompt.shape[0],
                                                DONATE_CACHE)
    layer = _first_with(cache, "ckv")
    layer = {k: layer[k] for k in ("ckv", "krope")}
    g = torch.Generator().manual_seed(1)
    new = {k: distribute_tensor(torch.randn(t.shape, generator=g).to(
        t.dtype), mesh, placements(rules.spec("dp", None, None), mesh))
        for k, t in layer.items()}
    locals_ = [t.to_local() for t in (*layer.values(), *new.values())]
    cost = LocalCost(None, locals_)
    base = cost.now
    with cost:
        write_prompt_mesh(layer, new, mesh, True)
    out["write_temp"] = cost.peak - base
    out["leaf_bytes"] = max(t.to_local().nbytes for t in layer.values())
    out["written"] = all(torch.equal(layer[k].full_tensor(),
                                     new[k].full_tensor()) for k in layer)
    return out


def _first_with(tree, key):
    """The first dict in ``tree`` (nested dicts / lists) that has ``key``."""
    if isinstance(tree, dict) and key in tree:
        return tree
    subs = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, list) else ())
    for sub in subs:
        found = _first_with(sub, key)
        if found is not None:
            return found
    return None


def _archs_case(rules):
    """Every smoke architecture's batch gradients on the mesh and on one
    device (the port's; one device is held against the reference by
    ``test_torch_lm_train_archs.py``), MoE capacity drops off and the aux
    loss weighted 0 (its per-dp-shard estimate is another function of
    the batch than the global one).  Also the one-device gradients' own
    float32 sensitivity: their change when every parameter is scaled by
    1 + 2^-23 x a standard normal draw (about one float32 rounding)."""
    from repro_torch.configs import get_smoke_config, list_archs
    from repro_torch.models import Model
    from repro_torch.train.train_step import batch_grads
    from repro_torch.tree import tree_leaves, tree_map
    out = {}

    def rel(g, h):
        return max(float((a - _tensor(b)).abs().max()
                         / a.abs().max().clamp_min(1e-30))
                   for a, b in zip(tree_leaves(g), tree_leaves(h)))

    for arch in list_archs():
        cfg = get_smoke_config(arch)
        if cfg.moe is not None:
            cfg = cfg.with_(moe=replace(cfg.moe, capacity_factor=16.0))
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 17)).astype(np.int32))}
        if cfg.input_mode == "tokens+prefix":
            batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
                (4, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32))
        elif cfg.input_mode == "embeddings":
            batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
                (4, 16, cfg.d_model)).astype(np.float32))
        one, sharded = Model(cfg, "cpu"), Model(cfg, "cpu", rules)
        params = one.init(torch.Generator().manual_seed(0))
        g1, m1 = batch_grads(one, params, batch, aux_weight=0.0)
        g2, m2 = batch_grads(sharded, sharded.init(
            torch.Generator().manual_seed(0)), _rows(batch, rules),
            aux_weight=0.0)
        noise = torch.Generator().manual_seed(1)
        nudged = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
            t.shape, generator=noise)), params)
        g3, _ = batch_grads(one, nudged, batch, aux_weight=0.0)
        out[arch] = {
            "d_loss": abs(float(m1["loss"]) - float(m2["loss"])),
            "grad_rel": rel(g1, g2), "sensitivity": rel(g1, g3)}
    return out


def _tensor(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _uneven_rglru_config():
    """RecurrentGemma's smoke config with 5 heads of 16 channels: tp 2 and
    4 split the 80 channels but not the heads (``recurrentgemma-2b``: 10
    heads of 256, tp 16)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("recurrentgemma-2b")
    return cfg.with_(n_heads=UNEVEN_HEADS,
                     rglru=replace(cfg.rglru, width=UNEVEN_HEADS * 16))


def _one_function_recurrence(p, u, cfg, cache, decode: bool):
    """``rglru._recurrence`` written as one function (the conv, the gates
    and the RG-LRU inline): where whole heads divide tp, the mesh's bits
    are held against it."""
    from repro_torch.models import rglru as rg
    g = cfg.rglru
    u, conv_state = rg._causal_conv(p["conv"], u,
                                    cache["conv"] if decode else None)
    r = rg._block_linear(p["gate"]["r"]["blocks"], u) \
        + p["gate"]["r"]["b"].to(u.dtype)
    i = rg._block_linear(p["gate"]["i"]["blocks"], u) \
        + p["gate"]["i"]["b"].to(u.dtype)
    decay = -g.c * torch.nn.functional.softplus(p["lam"])
    log_a = decay * torch.sigmoid(r.float())
    gated = torch.sigmoid(i.float()) * u.float()
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * gated
    if decode:
        h = torch.exp(log_a[:, 0]) * cache["h"].float() + bx[:, 0]
        return h[:, None], {"h": h.to(cache["h"].dtype), "conv": conv_state}
    hs = rg._rglru_scan(log_a, bx, cache["h"].float()
                        if cache is not None else None)
    if cache is None:
        return hs, None
    return hs, {"h": hs[:, -1].to(cache["h"].dtype), "conv": conv_state}


def _rglru_serve_and_grads(cfg, rules, prompt):
    """Prefill + ``DECODE_STEPS`` logits and one batch's gradients of
    ``cfg`` on the mesh and on one device (seed-0 weights, one device's
    tokens fed to both), the mesh's caches' placements and its one-device
    gradients' float32 sensitivity (as ``_archs_case``)."""
    from repro_torch.models import Model
    from repro_torch.train.train_step import batch_grads
    from repro_torch.tree import tree_leaves, tree_map
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = rules.mesh
    one, sharded = Model(cfg, "cpu"), Model(cfg, "cpu", rules)
    params = one.init(torch.Generator().manual_seed(0))
    placed = _sharded(sharded, params)
    runs, fed = [], []
    for model, p, tok in ((one, params, torch.from_numpy(prompt)),
                          (sharded, placed,
                           _rows({"t": torch.from_numpy(prompt)},
                                 rules)["t"])):
        cache = model.init_cache(prompt.shape[0],
                                 prompt.shape[1] + DECODE_STEPS + 1)
        lg, cache = model.prefill(p, tok, cache)
        steps = [_tensor(lg)]
        for i in range(DECODE_STEPS):
            if model is one:
                fed.append(torch.argmax(steps[-1][:, -1], -1))
            nxt = fed[i]
            if model is sharded:
                nxt = distribute_tensor(nxt, mesh, [Replicate()] * mesh.ndim)
            lg, cache = model.decode_step(p, nxt, cache)
            steps.append(_tensor(lg))
        runs.append(steps)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))}
    g1, m1 = batch_grads(one, params, batch)
    g2, m2 = batch_grads(sharded, placed, _rows(batch, rules))
    noise = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
        t.shape, generator=noise)), params)
    g3, _ = batch_grads(one, nudged, batch)

    def rel(g, h):
        return max(float((a - _tensor(b)).abs().max()
                         / a.abs().max().clamp_min(1e-30))
                   for a, b in zip(tree_leaves(g), tree_leaves(h)))

    mix = placed["scan"][0]["mixer"]
    state = cache["scan"][0][0]
    return {"logits": [t.numpy() for t in runs[1]],
            "logit_err": max(float((a - b).abs().max())
                             for a, b in zip(*runs)),
            "grads": [_tensor(t).numpy() for t in tree_leaves(g2)],
            "d_loss": abs(float(m1["loss"]) - float(m2["loss"])),
            "grad_rel": rel(g1, g2), "sensitivity": rel(g1, g3),
            "placements": {
                "lam": mix["lam"].placements,
                "conv.w": mix["conv"]["w"].placements,
                "gate.blocks": mix["gate"]["r"]["blocks"].placements,
                "h": state["h"].placements,
                "conv": state["conv"].placements}}


def _rglru_case(rules, prompt):
    """RG-LRU on the mesh.  Heads tp does not divide
    (``_uneven_rglru_config``): what ``_rglru_serve_and_grads`` gives, and
    the width each call of the RG-LRU saw (spied).  Heads tp divides (the
    smoke config): logits and gradients with the recurrence as it is and
    as one function (``_one_function_recurrence``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import rglru as rg
    widths = []
    lru = rg._lru

    def spied(lam, u, *a):
        widths.append(u.shape[-1])
        return lru(lam, u, *a)

    rg._lru = spied
    try:
        out = {"uneven": _rglru_serve_and_grads(_uneven_rglru_config(),
                                                rules, prompt)}
    finally:
        rg._lru = lru
    out["uneven"]["widths"] = widths
    cfg = get_smoke_config("recurrentgemma-2b")
    out["even"] = _rglru_serve_and_grads(cfg, rules, prompt)
    recurrence = rg._recurrence
    rg._recurrence = _one_function_recurrence
    try:
        out["even_one_function"] = _rglru_serve_and_grads(cfg, rules, prompt)
    finally:
        rg._recurrence = recurrence
    return out


def _ssd_term_inputs():
    """mamba2's smoke SSD: layer 0's scan parameters (seed-0 weights) and
    numpy-seeded u, B, C, dt and a cotangent on the scan's output, as
    numpy arrays; 4 sequences of 24 steps (two chunks of 16)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = get_smoke_config("mamba2-780m")
    s = cfg.ssd
    din = s.expand * cfg.d_model
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    mix = params["scan"][0]["mixer"]
    out = {"conv_x.w": mix["conv_x"]["w"][0], "conv_x.b": mix["conv_x"]["b"][0]}
    out.update({k: mix[k][0] for k in ("A_log", "dt_bias", "D_skip")})
    out = {k: v.detach().numpy() for k, v in out.items()}
    rng = np.random.default_rng(4)
    B, S = 4, 24
    for k, shape in (("u", (B, S, din)),
                     ("Bv", (B, S, s.n_groups * s.d_state)),
                     ("Cv", (B, S, s.n_groups * s.d_state)),
                     ("dt", (B, S, din // s.head_dim)), ("ct", (B, S, din))):
        out[k] = rng.standard_normal(shape).astype(np.float32)
    return cfg, out


def _ssd_core(t):
    return {"conv_x": {"w": t["conv_x.w"], "b": t["conv_x.b"]},
            **{k: t[k] for k in ("A_log", "dt_bias", "D_skip")}}


def _ssd_term_case(rules):
    """The SSD scan alone on the mesh (``ssd._scan_mesh``): its inputs
    (``_ssd_term_inputs``) as replicated DTensor leaves, the cotangent on
    its output; every input's gradient, gathered whole."""
    from repro_torch.models import ssd
    from torch.distributed.tensor import Replicate, distribute_tensor
    cfg, arrays = _ssd_term_inputs()
    mesh = rules.mesh
    whole = [Replicate()] * mesh.ndim
    leaves = {k: distribute_tensor(torch.from_numpy(v), mesh, whole)
              .requires_grad_() for k, v in arrays.items() if k != "ct"}
    ys, _ = ssd._scan_mesh(_ssd_core(leaves), leaves["u"], leaves["Bv"],
                           leaves["Cv"], leaves["dt"], cfg, None, False,
                           rules)
    ys.backward(distribute_tensor(torch.from_numpy(arrays["ct"]), mesh,
                                  ys.placements))
    return {k: t.grad.full_tensor().numpy() for k, t in leaves.items()}


def _world_a(rank, world, store, ref, ckpt_dir, out_path):
    _init(rank, world, store)
    from repro_torch.configs import get_smoke_config
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.distributed import compressed_psum
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_mesh, make_smoke_mesh
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.models import Model
    rules = make_rules(make_smoke_mesh(2, 4, device="cpu"))
    out = {"olmo": _step_case(rules, "olmo-1b", ref["olmo_init"],
                              ref["olmo_tokens"]),
           "gqa": _step_case(rules, "llama3-405b", ref["gqa_init"],
                             ref["olmo_tokens"]),
           "moe": _moe_case(rules, ref["moe_init"], ref["moe_tokens"],
                            ref["prompt"], ref["x2d"]),
           "generate": _generate_case(rules, ref["prompt"]),
           "serve_archs": _serve_archs_case(rules, ref["prompt"]),
           "archs": _archs_case(rules),
           "rglru": _rglru_case(rules, ref["prompt"]),
           "ssd_term": _ssd_term_case(rules),
           "donate": _donate_case(rules, ref["prompt"])}
    line = make_mesh((8,), ("d",), device="cpu")
    row = torch.from_numpy(ref["psum_x"][rank:rank + 1])
    got = compressed_psum(row, (line, "d"))
    rows = [torch.empty_like(got) for _ in range(world)]
    dist.all_gather(rows, got)
    out["psum"] = torch.cat(rows).numpy()
    cfg = get_smoke_config("stablelm-1.6b")
    model = Model(cfg, "cpu", rules)
    params = model.init(torch.Generator().manual_seed(0))
    save_checkpoint(ckpt_dir, 1, params)
    out["saved"] = [_full(t) for t in _flatten(params)]
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def _uneven_tree():
    """Leaves for a save on (4, 2): bf16 sharded over both axes on two
    dims, a float32 leaf split unevenly (an empty shard among them), one
    replicated, and plain 0-dim leaves."""
    from torch.distributed.tensor import Replicate, Shard
    g = torch.Generator().manual_seed(5)
    whole = {"a": torch.randn(8, 6, 12, generator=g).to(torch.bfloat16),
             "b": torch.randn(7, 3, generator=g),
             "c": torch.randn(5, 4, generator=g),
             "n": torch.zeros((), dtype=torch.int32),
             "s": torch.tensor(3.0)}
    placed = {"a": [Shard(1), Shard(2)], "b": [Shard(0), Shard(1)],
              "c": [Replicate(), Replicate()]}
    return whole, placed


def _world_b(rank, world, store, dirs, out_path):
    _init(rank, world, store)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.checkpoint.checkpointer import _flatten, _leaf_shardings
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_rules, shardings_for
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import Model
    cfg = get_smoke_config("stablelm-1.6b")
    rules = make_rules(make_smoke_mesh(4, 2, device="cpu"))
    like = Model(cfg, "meta").init()
    asked = shardings_for(like, rules)
    out = {"rglru": _rglru_case(rules, dirs["prompt"]),
           "ssd_term": _ssd_term_case(rules)}
    for name in ("reference", "port"):
        got, step, _ = restore_checkpoint(dirs[name], like, shardings=asked)
        leaves = _flatten(got)
        out[name] = {
            "step": step, "arrays": [_full(t) for t in leaves],
            "placed": all(t.placements == tuple(pl) and t.device_mesh.shape
                          == (4, 2) for t, (_, pl) in zip(
                              leaves, _leaf_shardings(like, asked)))}
    whole, placed = _uneven_tree()
    save_checkpoint(dirs["uneven"], 1, {
        k: distribute_tensor(v, rules.mesh, placed[k]) if k in placed else v
        for k, v in whole.items()})
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def _world_c(rank, world, store, ckpt_dir, out_path):
    _init(rank, world, store)
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import run_with_restarts
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import train_loop
    mesh = make_smoke_mesh(2, 2, device="cpu")
    attempts = []

    def loop(attempt):
        attempts.append(attempt)
        return train_loop(cfg=get_smoke_config("olmo-1b"), ckpt=ckpt_dir,
                          mesh=mesh, fail_at=3 if attempt == 0 else None,
                          **TRAIN_LOOP)

    metrics = run_with_restarts(loop, max_restarts=1)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump({"metrics": metrics, "attempts": attempts}, f)
    dist.destroy_process_group()


# ----------------------------------------------------------- reference
REF_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.checkpoint import save_checkpoint
from repro.configs import get_smoke_config
from repro.distributed.compression import compressed_psum
from repro.distributed.sharding import make_rules
from repro.launch.mesh import make_smoke_mesh
from repro.models import build_model
assert jax.device_count() == 8
out = sys.argv[1]
try:
    shard_map = jax.shard_map
except AttributeError:
    from jax.experimental.shard_map import shard_map
line = jax.make_mesh((8,), ("d",))
x = jnp.asarray(np.load(os.path.join(out, "psum_x.npy")))
y = jax.jit(shard_map(lambda v: compressed_psum(v, "d"), mesh=line,
                      in_specs=P("d"), out_specs=P("d")))(x)
np.save(os.path.join(out, "psum_y.npy"), np.asarray(y))
cfg = get_smoke_config("stablelm-1.6b")
mesh = make_smoke_mesh(2, 4)
m = build_model(cfg, make_rules(mesh))
with mesh:
    p = m.init(jax.random.key(0))
save_checkpoint(os.path.join(out, "ref_ckpt"), 1, p)
"""


@pytest.fixture(scope="module")
def results():
    """Every world's results and the reference's numbers."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as r_restore
    from repro.configs import get_smoke_config as r_smoke
    from repro.models import build_model
    from repro.models import moe as r_moe
    from repro.train import init_train_state, make_train_step
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train_loop

    work = tempfile.mkdtemp(prefix="torch_dist_")
    rng = np.random.default_rng(0)
    psum_x = rng.standard_normal((8, 64)).astype(np.float32)
    np.save(os.path.join(work, "psum_x.npy"), psum_x)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
                           work], env=env, capture_output=True, text=True,
                          timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]

    ref: dict = {"psum_x": psum_x}
    want: dict = {"psum": np.load(os.path.join(work, "psum_y.npy"))}
    tokens = np.random.default_rng(0).integers(
        0, 512, OLMO_TOKENS).astype(np.int32)
    ref["olmo_tokens"] = tokens
    for key, arch in (("olmo", "olmo-1b"), ("gqa", "llama3-405b")):
        model = build_model(r_smoke(arch))
        s0 = init_train_state(model, jax.random.key(0))
        ref[f"{key}_init"] = jax.tree.map(np.asarray, s0.params)
        s1, met = jax.jit(make_train_step(model, peak_lr=1e-3))(
            s0, {"tokens": jnp.asarray(tokens)})
        want[key] = {"loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"]),
                     "params": [np.asarray(t, np.float32)
                                for t in jax.tree.leaves(s1.params)],
                     "m": [np.asarray(t) for t in jax.tree.leaves(s1.opt.m)],
                     "v": [np.asarray(t) for t in jax.tree.leaves(s1.opt.v)]}

    cfg = r_smoke("qwen3-moe-235b-a22b")
    cfg = cfg.with_(moe=replace(cfg.moe, capacity_factor=16.0))
    model = build_model(cfg)
    p = model.init(jax.random.key(0))
    ref["moe_init"] = jax.tree.map(np.asarray, p)
    ref["moe_tokens"] = np.random.default_rng(1).integers(
        0, cfg.vocab_size, MOE_TOKENS).astype(np.int32)
    ref["prompt"] = np.random.default_rng(2).integers(
        0, cfg.vocab_size, PROMPT).astype(np.int32)
    ref["x2d"] = np.random.default_rng(3).standard_normal(
        (PROMPT[0], 1, cfg.d_model)).astype(np.float32)
    logits, aux = jax.jit(model.forward)(p, jnp.asarray(ref["moe_tokens"]))
    layer = jax.tree.map(lambda t: t[0], p["scan"][0]["ffn"]["moe"])
    y2d, aux2d = r_moe.moe_ffn(layer, jnp.asarray(ref["x2d"]), cfg,
                               act=cfg.act)
    cache = model.init_cache(PROMPT[0], PROMPT[1] + DECODE_STEPS)
    lg, cache = jax.jit(model.prefill)(p, jnp.asarray(ref["prompt"]), cache)
    steps = [np.asarray(lg)]
    dec = jax.jit(model.decode_step)
    for _ in range(DECODE_STEPS):
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
        lg, cache = dec(p, tok, cache)
        steps.append(np.asarray(lg))
    want["moe"] = {"logits": np.asarray(logits), "aux": float(aux),
                   "y2d": np.asarray(y2d), "aux2d": float(aux2d),
                   "decode": steps}

    port_ckpt = os.path.join(work, "port_ckpt")
    _run_world(_world_a, 8, ref, port_ckpt, os.path.join(work, "a.pkl"))
    _run_world(_world_b, 8, {"reference": os.path.join(work, "ref_ckpt"),
                             "port": port_ckpt,
                             "uneven": os.path.join(work, "uneven_ckpt"),
                             "prompt": ref["prompt"]},
               os.path.join(work, "b.pkl"))
    _run_world(_world_c, 4, os.path.join(work, "loop_ckpt"),
               os.path.join(work, "c.pkl"))
    got = {}
    for name in "abc":
        with open(os.path.join(work, f"{name}.pkl"), "rb") as f:
            got[name] = pickle.load(f)

    r_params, _, _ = r_restore(os.path.join(work, "ref_ckpt"),
                               build_model(r_smoke("stablelm-1.6b")).init(
                                   jax.random.key(0)))
    want["ref_ckpt"] = [np.asarray(t) for t in jax.tree.leaves(r_params)]
    from_port, step, _ = r_restore(port_ckpt, r_params)
    want["port_in_reference"] = (step, [np.asarray(t) for t in
                                        jax.tree.leaves(from_port)])
    want["uneven"] = (os.path.join(work, "uneven_ckpt"),
                      _uneven_tree()[0])
    want["loop"] = train_loop(cfg=get_smoke_config("olmo-1b"), ckpt=None,
                              device="cpu", **TRAIN_LOOP)
    return got, want


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("case", ["olmo", "gqa"])
def test_sharded_train_step_matches_reference(results, case):
    got, want = results
    g, w = got["a"][case], want[case]
    assert abs(g["loss"] - w["loss"]) < LOSS_TOL, (g["loss"], w["loss"])
    assert len(g["params"]) == len(w["params"])
    d_par = max(float(np.abs(a - b).max())
                for a, b in zip(g["params"], w["params"]))
    assert d_par < PARAM_TOL, d_par


@pytest.mark.parametrize("case", ["olmo", "gqa"])
def test_sharded_gradients_match_reference(results, case):
    """The step's learning rate is 0 in the warm-up, so its parameters are
    the initial ones; its moments carry the mesh's gradients (m = 0.1 g,
    v = 0.05 g^2, g clipped by the global norm).  The grad norm at the
    archs test's metric rtol, each m leaf within 1e-4 of its largest |m|
    (its gradient bound), each v leaf within 2e-4 of its largest |v| (a
    square doubles the relative error)."""
    got, want = results
    g, w = got["a"][case], want[case]
    assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"], (
        g["grad_norm"], w["grad_norm"])
    for name, bound in (("m", 1e-4), ("v", 2e-4)):
        assert len(g[name]) == len(w[name])
        rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                  for a, b in zip(g[name], w[name]))
        assert rel < bound, (name, rel)


@pytest.mark.parametrize("case", ["olmo", "gqa"])
def test_params_and_moments_keep_their_placements(results, case):
    assert results[0]["a"][case]["kept"]


def test_moe_forward_on_the_mesh_matches_reference(results):
    got, want = results
    g, w = got["a"]["moe"], want["moe"]
    assert float(np.abs(g["logits"] - w["logits"]).max()) < MOE_ERR
    # the aux loss is E * sum f_e P_e per dp shard, then averaged: it
    # differs slightly from the global estimate, as in the reference
    assert abs(g["aux"] - w["aux"]) < AUX_ERR


def test_moe_decode2d_form_matches_reference(results):
    got, want = results
    g, w = got["a"]["moe"], want["moe"]
    assert g["y2d"].shape == w["y2d"].shape
    assert float(np.abs(g["y2d"] - w["y2d"]).max()) < MOE_ERR
    assert abs(g["aux2d"] - w["aux2d"]) < AUX_ERR


def test_moe_prefill_and_decode_on_the_mesh_match_reference(results):
    got, want = results
    for g, w in zip(got["a"]["moe"]["decode"], want["moe"]["decode"]):
        assert float(np.abs(g - w).max()) < LOGIT_ATOL


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-2b", "stablelm-1.6b",
                                  "olmo-1b", "qwen2-72b", "llama3-405b",
                                  "internvl2-1b", "musicgen-medium",
                                  "mamba2-780m"])
def test_every_arch_trains_on_the_mesh_as_on_one_device(results, arch):
    """Attention, MLA, RG-LRU, SSD and MLPs tensor-parallel, the
    vocabulary over tp: the loss within the reference's bound and every
    gradient leaf within 1e-4 of its largest |g| (the bound of
    ``test_torch_lm_train_archs.py``), or within 4 times the gradients'
    own float32 sensitivity where that is larger (mamba2's SSD: a
    one-rounding nudge of the parameters moves its gradients by ~2.5e-4
    of their largest |g|, and the heads split over tp sum in another
    order; a gradient missing a rank's part is off by ~0.5)."""
    r = results[0]["a"]["archs"][arch]
    assert r["d_loss"] < LOSS_TOL, r
    assert r["grad_rel"] < max(1e-4, 4 * r["sensitivity"]), r


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_tensor_parallel_mixers_serve_on_the_mesh_as_on_one_device(
        results, arch):
    """MLA (heads over tp; decode's latent scores over the cache's
    sequence split over tp), RG-LRU (channels over tp) and SSD (heads
    over tp): prefill and decode logits within the logits' bound."""
    err = results[0]["a"]["serve_archs"][arch]
    assert err < LOGIT_ATOL, err


@pytest.mark.parametrize("world", ["a", "b"])
def test_rglru_channels_split_over_tp_where_heads_do_not_divide(results,
                                                                world):
    """(2, 4) and (4, 2) with 5 heads of 16 channels (tp splits the
    channels, not the heads, as for ``recurrentgemma-2b``'s 10 heads on tp
    16): ``lam``, the conv and the ``h`` / ``conv`` caches are sharded over
    tp and the gates' blocks replicated, as the reference's specs place
    them; the RG-LRU runs on 80 / tp channels on the mesh (and on 80 on
    one device: the spy saw both widths and no other); prefill and decode
    logits within ``LOGIT_ATOL`` of one device's, the loss within the
    reference's bound and the gradients within the archs test's bound."""
    from torch.distributed.tensor import Replicate, Shard
    tp = {"a": 4, "b": 2}[world]
    r = results[0][world]["rglru"]["uneven"]
    assert r["placements"] == {
        "lam": (Replicate(), Shard(1)), "conv.w": (Replicate(), Shard(1)),
        "gate.blocks": (Replicate(), Replicate()),
        "h": (Shard(0), Shard(1)), "conv": (Shard(0), Shard(2))}
    assert set(r["widths"]) == {UNEVEN_HEADS * 16,
                                UNEVEN_HEADS * 16 // tp}
    assert r["logit_err"] < LOGIT_ATOL, r["logit_err"]
    assert r["d_loss"] < LOSS_TOL
    assert r["grad_rel"] < max(1e-4, 4 * r["sensitivity"]), r


@pytest.mark.parametrize("world", ["a", "b"])
def test_rglru_where_heads_divide_tp_keeps_its_bits(results, world):
    """Whole heads over tp (the smoke config's 4 heads on tp 4 and 2): the
    mesh's logits and gradients equal, bit for bit, those of the
    recurrence written as one function."""
    r = results[0][world]["rglru"]
    got, want = r["even"], r["even_one_function"]
    for key in ("logits", "grads"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)


def _ssd_grads(h0: int, n: int, rows: slice = slice(None)) -> dict:
    """One device: the gradients of ``_ssd_term_inputs`` through ``_scan``
    of heads [h0, h0 + n) on the batch ``rows`` (their channels, their
    dt, their parameters; B and C whole) under the cotangent's part for
    those heads and rows: what one rank of the mesh computes."""
    from repro_torch.models import ssd
    cfg, arrays = _ssd_term_inputs()
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()
         if k != "ct"}
    ch = slice(h0 * cfg.ssd.head_dim, (h0 + n) * cfg.ssd.head_dim)
    hs = slice(h0, h0 + n)
    core = _ssd_core({"conv_x.w": t["conv_x.w"][ch],
                      "conv_x.b": t["conv_x.b"][ch],
                      **{k: t[k][hs] for k in ("A_log", "dt_bias",
                                               "D_skip")}})
    y, _ = ssd._scan(core, t["u"][rows, :, ch], t["Bv"][rows],
                     t["Cv"][rows], t["dt"][rows, :, hs], cfg, None, False,
                     h0)
    y.backward(torch.from_numpy(arrays["ct"][rows, :, ch]))
    return {k: v.grad.numpy() for k, v in t.items()}


@pytest.mark.parametrize("world", ["a", "b"])
def test_ssd_b_and_c_gradients_are_the_sum_tp_reorders(results, world):
    """mamba2's SSD scan alone (``ssd._scan_mesh``) on (2, 4) and (4, 2),
    held against what each rank computes, run on one device
    (``_ssd_grads`` of its batch rows and heads).  u's and dt's gradients
    are the ranks' own entries, bit for bit: no sum across ranks.  B's and
    C's gradients are the one sum tp reorders: one device adds the heads
    in order (``repeat_interleave``'s backward); the mesh adds each rank's
    heads, then the ranks' partial sums in an all-reduce over tp.  On
    (4, 2) two partial sums add in one addition, exactly, so the mesh's B
    and C gradients equal the ranks' partial sums added, bit for bit; on
    (2, 4) the collective groups four partial sums its own way, within the
    reordering bound of a four-term sum (2 (tp - 1) float32 epsilons of
    the sum of their magnitudes).  One device's B and C gradients are its
    heads' terms added in head order, bit for bit."""
    got = results[0][world]["ssd_term"]
    cfg, _ = _ssd_term_inputs()
    s = cfg.ssd
    H = s.expand * cfg.d_model // s.head_dim
    dp, tp = {"a": (2, 4), "b": (4, 2)}[world]
    nb, nh, P = 4 // dp, H // tp, s.head_dim
    ranks = [[_ssd_grads(t * nh, nh, slice(d * nb, (d + 1) * nb))
              for t in range(tp)] for d in range(dp)]
    for k, width in (("u", nh * P), ("dt", nh)):
        own = np.concatenate([np.concatenate(
            [ranks[d][t][k][d * nb:(d + 1) * nb, :,
                            t * width:(t + 1) * width] for t in range(tp)],
            -1) for d in range(dp)], 0)
        np.testing.assert_array_equal(got[k], own)
    eps = np.finfo(np.float32).eps
    one = _ssd_grads(0, H)
    heads = [_ssd_grads(h, 1) for h in range(H)]
    for k in ("Bv", "Cv"):
        in_order = heads[0][k]
        for h in heads[1:]:
            in_order = in_order + h[k]
        np.testing.assert_array_equal(one[k], in_order)
        for d in range(dp):
            rows = slice(d * nb, (d + 1) * nb)
            parts = [ranks[d][t][k][rows] for t in range(tp)]
            if tp == 2:
                np.testing.assert_array_equal(got[k][rows],
                                              parts[0] + parts[1])
            seq = parts[0]
            for x in parts[1:]:
                seq = seq + x
            bound = 2 * (tp - 1) * eps * sum(np.abs(x) for x in parts)
            assert (np.abs(got[k][rows] - seq) <= bound).all()


@pytest.mark.parametrize("arch", DONATE_ARCHS)
@pytest.mark.parametrize("prompt_len", [6, DONATE_CACHE])
def test_donated_mesh_serving_equals_the_functional_bits(results, arch,
                                                         prompt_len):
    """On (2, 4), the cache's sequence split over tp: prefill (and, for
    the short prompt, 6 decode steps writing into two ranks' chunks) with
    ``donate=True`` give the functional mesh run's logits and final cache
    bit for bit, in the cache's own tensors and storage."""
    r = results[0]["a"]["donate"][(arch, prompt_len)]
    assert r["entries"] > 0 and r["differ"] == 0, r
    assert r["aliased"], r


def test_donated_mesh_prefill_writes_each_ranks_range_in_place(results):
    """A prompt as long as MLA's latent cache, replicated over tp, is
    written into each rank's local shard: the write's extra bytes are at
    most one cache leaf's local shard (where building the new cache and
    laying it out would hold it twice), and the cache holds the prompt."""
    r = results[0]["a"]["donate"]
    assert r["written"]
    assert r["write_temp"] <= r["leaf_bytes"], r


def test_generate_on_the_mesh_gives_one_devices_tokens(results):
    g = results[0]["a"]["generate"]
    np.testing.assert_array_equal(g["got"], g["want"])


def test_compressed_psum_is_the_references_bit_for_bit(results):
    got, want = results
    assert got["a"]["psum"].dtype == np.float32
    np.testing.assert_array_equal(got["a"]["psum"].view(np.uint32),
                                  want["psum"].view(np.uint32))


def test_reference_checkpoint_restores_on_another_mesh(results):
    got, want = results
    b = got["b"]["reference"]
    assert b["step"] == 1 and b["placed"]
    assert len(b["arrays"]) == len(want["ref_ckpt"])
    assert sum(int((x != y).sum()) for x, y in zip(b["arrays"],
                                                    want["ref_ckpt"])) == 0


def test_port_checkpoint_restores_on_another_mesh(results):
    got, _ = results
    b = got["b"]["port"]
    assert b["step"] == 1 and b["placed"]
    assert sum(int((x != y).sum()) for x, y in zip(
        b["arrays"], got["a"]["saved"])) == 0


def test_sharded_save_writes_every_shard_in_place(results):
    """Each rank writes its shards into the leaf's file (one writer per set
    of replicas, none gathering a leaf): the files hold the whole leaves,
    bf16 as its bits."""
    from repro_torch.checkpoint import restore_checkpoint
    d, whole = results[1]["uneven"]
    got, step, _ = restore_checkpoint(d, whole, device="cpu")
    assert step == 1
    for k, w in whole.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_port_mesh_checkpoint_restores_in_reference(results):
    got, want = results
    step, arrays = want["port_in_reference"]
    assert step == 1
    assert sum(int((x != y).sum()) for x, y in zip(
        arrays, got["a"]["saved"])) == 0


def test_train_loop_on_a_mesh_resumes_to_the_one_device_run(results):
    got, want = results
    c = got["c"]
    assert c["attempts"] == [0, 1]
    for k, w in want["loop"].items():
        assert abs(c["metrics"][k] - w) <= LOSS_TOL * max(1.0, abs(w)), k
