"""Composable decoder LM over a per-layer block pattern.

One ``Model`` covers all ten assigned architectures, as the reference's:

- the config's ``block_pattern`` is split into (prelude, scanned
  super-blocks, postlude): DeepSeek-V2's first dense-FFN layer is the
  prelude; RecurrentGemma's (R, R, A) pattern is one super-block of three
  sub-layers; uniform stacks have super-blocks of one;
- scanned layer parameters are stacked on a leading dim, in the
  reference's layout (``params_from_reference`` carries its pytree over
  as is); the walk takes group ``i``'s views in a loop.  Caches are
  listed per group;
- modes: ``forward`` (logits; the train-mode forward, with each scan
  group under ``torch.utils.checkpoint`` when grad mode is on and
  ``cfg.remat`` is not ``"none"``), ``prefill`` (last logits + cache),
  ``decode_step`` (one token + cache update).  Caches are not written in
  place: each step returns a new one, unless the caller donates its cache
  (``donate=True``: every mixer writes into the cache's tensors and the
  step returns them; the cache passed in is spent).

Under a mesh (``rules`` from ``distributed.sharding.make_rules``) the
parameters and caches are DTensors placed by the reference's specs, and
the walk takes the reference's mesh layout: activations pinned by
``rules.act`` (a redistribute), each scan group's sliced parameters
pinned to one group's specs (``_pin_group``), Megatron sequence
parallelism between blocks in the forward (``sp``), decode's 2D layout
(the residual's hidden dim over dp, ``decode2d``), the MoE experts and
the blockwise flash under ``shard_map``.  MLA and the recurrent mixers
(RG-LRU, SSD) keep their projections in their specs' layout and run
their attention or scan on each rank's heads or channels under
``shard_map``.  Without a mesh the one-device code runs unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.collectives import axis_index, pmean, psum
from ..distributed.sharding import (P, GradSpec, ShardingRules, cache_pspecs,
                                    distribute, make_rules, param_pspecs,
                                    placements, shard_map)
from ..tree import tree_leaves, tree_map, tree_unzip
from . import attn as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssd as ssd_mod
from .layers import (ParamRng, init_norm, apply_norm, init_gated_mlp,
                     gated_mlp, init_dense, mm32)

__all__ = ["Model", "build_model", "param_count", "params_from_reference",
           "layer_groups", "tree_map", "tree_leaves", "tree_unzip"]


# ----------------------------------------------------------------- grouping
def layer_groups(cfg: ModelConfig):
    """(prelude_kinds, superblock_kinds, n_scan, postlude_kinds)."""
    pat = list(cfg.block_pattern)
    pre: list[str] = []
    if cfg.moe is not None and cfg.moe.first_dense:
        pre = pat[:cfg.moe.first_dense]
        pat = pat[cfg.moe.first_dense:]
    if cfg.rglru is not None:
        sb = list(cfg.rglru.pattern)
        n_scan = len(pat) // len(sb)
        post = pat[n_scan * len(sb):]
        return pre, sb, n_scan, post
    return pre, pat[:1] if pat else [], len(pat), []


# ------------------------------------------------------------------- blocks
def init_block(rng: ParamRng, cfg: ModelConfig, kind: str, moe_layer: bool,
               dtype):
    p: dict = {"norm1": init_norm(rng, cfg.norm, cfg.d_model, dtype)}
    if kind == "attn":
        if cfg.mla is not None:
            p["mixer"] = mla_mod.init_mla(rng, cfg, dtype)
        else:
            p["mixer"] = attn_mod.init_attn(rng, cfg, dtype)
    elif kind == "rglru":
        p["mixer"] = rglru_mod.init_rglru(rng, cfg, dtype)
    elif kind == "ssd":
        p["mixer"] = ssd_mod.init_ssd(rng, cfg, dtype)
    else:
        raise ValueError(kind)
    if kind == "ssd" or cfg.d_ff == 0:
        return p                      # mamba2: mixer-only block
    p["norm2"] = init_norm(rng, cfg.norm, cfg.d_model, dtype)
    if moe_layer:
        p["ffn"] = {"moe": moe_mod.init_moe(rng, cfg, dtype)}
        mo = cfg.moe
        if mo.n_shared:
            Fs = (mo.d_shared or mo.d_expert) * mo.n_shared
            p["ffn"]["shared"] = init_gated_mlp(rng, cfg.d_model, Fs, dtype)
    else:
        p["ffn"] = {"mlp": init_gated_mlp(rng, cfg.d_model, cfg.d_ff,
                                          dtype)}
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device):
    if kind == "attn":
        if cfg.mla is not None:
            return mla_mod.init_mla_cache(cfg, batch, max_len, dtype, device)
        window = cfg.rglru.window if cfg.rglru is not None else None
        return attn_mod.init_attn_cache(cfg, batch, max_len, dtype, device,
                                        window)
    if kind == "rglru":
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "ssd":
        return ssd_mod.init_ssd_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


class Model:
    """Functional model: ``init`` -> params dict; ``forward`` / ``prefill``
    / ``decode_step`` over it.  ``device=None`` is the card (an error
    without one); name ``"cpu"`` to run on the host.  ``rules`` with a
    mesh: the mesh path (its device type unless ``device`` names one)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 rules: ShardingRules | None = None):
        self.cfg = cfg
        self.rules = rules or make_rules(None)
        mesh = self.rules.mesh
        if device is None and mesh is not None:
            device = mesh.device_type
        self.device = resolve_device(device)
        self.pre, self.sb, self.n_scan, self.post = layer_groups(cfg)
        self.dtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.compute_dtype)
        self._group_specs_cache = None

    def _group_specs(self):
        """Specs of ONE scan group's (unstacked) params."""
        if self._group_specs_cache is None:
            rng = ParamRng("meta")
            shapes = [init_block(rng, self.cfg, kind, self.cfg.moe is not None,
                                 self.dtype) for kind in self.sb]
            self._group_specs_cache = param_pspecs(shapes, self.rules)
        return self._group_specs_cache

    def _pin_group(self, gp):
        """Re-place a scan group's sliced params by one group's specs, so
        the ZeRO all-gather stays per group."""
        if self.rules.mesh is None:
            return gp
        mesh = self.rules.mesh
        return tree_map(
            lambda t, s: t.redistribute(mesh, placements(s, mesh, t.dim())),
            gp, self._group_specs())

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator | None = None) -> dict:
        """Parameters drawn from ``generator`` (on the model's device;
        seed 0 when None): the reference's shapes, dtypes and scales.
        Under a mesh every leaf is drawn whole, as on one device, then
        placed by ``param_pspecs`` (each rank holds the whole tree for a
        moment: the parameters' bytes once, per rank)."""
        cfg = self.cfg
        dt = self.dtype
        rng = ParamRng(self.device, generator)
        params: dict = {
            "embed": {"embedding": rng.normal(
                (cfg.vocab_size, cfg.d_model), 1.0, dt)},
            "final_norm": init_norm(rng, cfg.norm, cfg.d_model, dt),
        }
        if not cfg.tie_embeddings:
            params["head"] = {"lm_head": rng.normal(
                (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5, dt)}
        if cfg.input_mode == "tokens+prefix":
            params["prefix"] = {"prefix_proj": init_dense(
                rng, cfg.d_model, cfg.d_model, dt)["w"]}
        if self.pre:
            params["prelude"] = [init_block(rng, cfg, kind, False, dt)
                                 for kind in self.pre]
        if self.n_scan:
            moe_layer = cfg.moe is not None
            groups = [[init_block(rng, cfg, kind, moe_layer, dt)
                       for kind in self.sb] for _ in range(self.n_scan)]
            params["scan"] = tree_map(lambda *xs: torch.stack(xs), *groups)
        if self.post:
            params["postlude"] = [init_block(rng, cfg, kind, False, dt)
                                  for kind in self.post]
        if self.rules.mesh is not None and not rng.meta:
            params = distribute(params, param_pspecs(params, self.rules),
                                self.rules.mesh)
        return params

    # -------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dt, dev = self.cfg, self.cdtype, self.device

        def blocks(kinds):
            return [init_block_cache(cfg, k, batch, max_len, dt, dev)
                    for k in kinds]

        cache: dict = {"len": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.pre:
            cache["prelude"] = blocks(self.pre)
        if self.n_scan:
            cache["scan"] = [blocks(self.sb) for _ in range(self.n_scan)]
        if self.post:
            cache["postlude"] = blocks(self.post)
        if self.rules.mesh is not None:
            cache = distribute(cache, cache_pspecs(cache, cfg, self.rules),
                               self.rules.mesh)
        return cache

    # -------------------------------------------------------------- apply
    def _block(self, p, x, kind: str, cache, cache_len, moe_layer: bool,
               sp: bool = False, donate: bool = False):
        cfg, r = self.cfg, self.rules
        mesh = r.mesh is not None
        seq_ax = "tp" if sp else None
        # decode's weight-stationary 2D layout: the residual's hidden dim
        # over the dp axes, so every product contracts a sharded dim
        # against the (d, m)-sharded weights
        decode2d = (mesh and cache is not None and x.shape[1] == 1
                    and cache_len is not None)

        def res_act(y):
            if decode2d:
                return r.act(y, None, None, "dp")
            return r.act(y, "dp", seq_ax, None)

        h = apply_norm(cfg.norm, p["norm1"], x)
        if sp:
            # Megatron-SP: gather the sequence before the TP projections
            h = r.act(h, "dp", None, None)
        if kind == "attn" and cfg.mla is None:
            window = cfg.rglru.window if cfg.rglru is not None else None
            mix, new_cache = attn_mod.attn_block(
                p["mixer"], h, cfg, window=window, cache=cache,
                cache_len=cache_len, rules=r if mesh else None,
                donate=donate)
        elif kind in ("attn", "rglru", "ssd"):
            block = {"attn": mla_mod.mla_block, "rglru": rglru_mod.rglru_block,
                     "ssd": ssd_mod.ssd_block}[kind]
            mix, new_cache = block(p["mixer"], h, cfg, cache=cache,
                                   cache_len=cache_len,
                                   rules=r if mesh else None, donate=donate)
        else:
            raise ValueError(kind)
        # the branch output placed as the residual first (under sp a
        # reduce-scatter), so its gradient reaches the output projection
        # sharded on the batch alone (a (batch, sequence) pair sharded
        # twice has no product strategy but gathering it whole)
        x = res_act(x + res_act(mix))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if "ffn" in p:
            h2 = apply_norm(cfg.norm, p["norm2"], x)
            if sp:
                h2 = r.act(h2, "dp", None, None)
            f = p["ffn"]
            pins = r if mesh and not decode2d else None
            if "moe" in f:
                y, aux = self._moe(f["moe"], h2, decode2d)
                if "shared" in f:
                    y = y + gated_mlp(f["shared"], h2, cfg.act, rules=pins)
            else:
                y = gated_mlp(f["mlp"], h2, cfg.act, rules=pins)
            x = res_act(x + res_act(y))
        return x, new_cache, aux

    def _moe(self, p, x, decode2d: bool = False):
        """The routed experts: one device, or the reference's
        ``shard_map`` over the mesh (experts over ``model``; tokens over
        dp, or replicated with the experts' hidden dim over dp in the 2D
        decode layout).  Each rank's gradients of the inputs it got
        replicated are partial sums over the axes it shares them on."""
        cfg, r = self.cfg, self.rules
        if r.mesh is None:
            return moe_mod.moe_ffn(p, x, cfg, act=cfg.act)
        mesh = r.mesh
        dp = r.dp if len(r.dp) > 1 else r.dp[0]
        model = (mesh, "model")
        every = tuple(mesh.mesh_dim_names)

        if decode2d:
            def local2d(pp, xx):
                y, aux = moe_mod.moe_ffn(pp, xx, cfg, axis_name=model,
                                         act=cfg.act, axis_data=(mesh, r.dp))
                return y, pmean(aux, model)

            in_specs = ({"router": {"w": P(None, None)},
                         "wi": P("model", dp, None),
                         "wg": P("model", dp, None),
                         "wo": P("model", None, dp)},
                        P(None, None, None))
            grads = ({"router": {"w": GradSpec(P(None, None), every)},
                      "wi": in_specs[0]["wi"], "wg": in_specs[0]["wg"],
                      "wo": in_specs[0]["wo"]},
                     GradSpec(P(None, None, None), every))
            return shard_map(local2d, mesh, in_specs,
                             (P(None, None, dp), P()), grads)(p, x)

        def local(pp, xx):
            y, aux = moe_mod.moe_ffn(pp, xx, cfg, axis_name=model,
                                     act=cfg.act)
            aux = pmean(aux, (mesh, r.dp))
            return y, pmean(aux, model)

        in_specs = ({"router": {"w": P(None, None)},
                     "wi": P("model", None, None),
                     "wg": P("model", None, None),
                     "wo": P("model", None, None)},
                    P(dp, None, None))
        grads = ({"router": {"w": GradSpec(P(None, None), every)},
                  **{n: GradSpec(P("model", None, None), r.dp)
                     for n in ("wi", "wg", "wo")}},
                 GradSpec(P(dp, None, None), ("model",)))
        return shard_map(local, mesh, in_specs, (P(dp, None, None), P()),
                         grads)(p, x)

    def _embed(self, params, tokens, prefix_embeds=None):
        cfg = self.cfg
        emb = params["embed"]["embedding"]
        if self.rules.mesh is None:
            x = F.embedding(tokens, emb)
        else:
            x = self._embed_mesh(emb, tokens)
        x = x.to(self.cdtype)
        if cfg.input_mode == "tokens+prefix" and prefix_embeds is not None:
            px = prefix_embeds.to(self.cdtype) \
                @ params["prefix"]["prefix_proj"].to(self.cdtype)
            x = torch.cat([px, x], 1)
        elif cfg.input_mode == "embeddings" and prefix_embeds is not None:
            x = prefix_embeds.to(self.cdtype)
        return self.rules.act(x, "dp", None, None)

    def _embed_mesh(self, emb, tokens):
        """The vocabulary-parallel lookup: each tp rank holds a slice of
        the vocabulary's rows (its D gathered over the ZeRO axes), looks up
        the tokens that fall in it (zero rows elsewhere), and a psum over
        tp completes every row (one nonzero term: exact)."""
        r = self.rules
        mesh = r.mesh
        tp = (mesh, r.tp) if r.tp else None

        def local(table, tok):
            if tp is None:
                return F.embedding(tok, table)
            v0 = axis_index(tp) * table.shape[0]
            rel = tok - v0
            mine = (rel >= 0) & (rel < table.shape[0])
            rows = F.embedding(torch.where(mine, rel, 0), table)
            return psum(torch.where(mine[..., None], rows, 0.0), tp)

        tspec = r.spec("tp", None)
        bspec = r.spec("dp", None)
        return shard_map(local, mesh, (tspec, bspec), r.spec("dp", None, None),
                         (GradSpec(tspec, r.dp), bspec))(emb, tokens)

    def _head(self, params, x):
        """float32 logits of the final norm against the (tied) head."""
        cfg = self.cfg
        x = apply_norm(cfg.norm, params["final_norm"], x)
        if self.rules.mesh is not None and any(
                p.is_shard(1) for p in x.placements):
            # sequence-parallel residual: gather the sequence before the
            # vocabulary-parallel product (Megatron-SP)
            x = self.rules.act(x, "dp", None, None)
        w = (params["embed"]["embedding"].T if cfg.tie_embeddings
             else params["head"]["lm_head"])
        return self.rules.act(mm32(x, w.to(x.dtype), "bsd,dv->bsv"),
                              "dp", None, "tp")

    def _stack_walk(self, params, x, cache, after_group=None,
                    donate: bool = False):
        """Run prelude -> scan groups -> postlude.  Returns (x, new_cache,
        aux).  ``after_group(i, x)``, when given, sees the hidden state
        after scan group ``i``.  The forward (no cache) under grad mode
        recomputes each scan group in the backward when ``cfg.remat`` asks
        for it; prefill and decode never do.  ``donate``: each block
        writes its new cache into ``cache``'s tensors."""
        cfg = self.cfg
        cache_len = cache["len"] if cache is not None else None
        # sequence parallelism in the forward (the reference's train mode)
        sp = bool(self.rules.sp and self.rules.mesh is not None
                  and cache is None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_cache: dict | None = {} if cache is not None else None

        def run(x, aux, blocks, kinds, caches, moe_layer):
            """The blocks in order: (x, aux, their new caches)."""
            outs = []
            for j, (p, kind) in enumerate(zip(blocks, kinds)):
                c = caches[j] if caches is not None else None
                x, nc, a = self._block(p, x, kind, c, cache_len, moe_layer,
                                       sp, donate)
                aux = aux + a
                outs.append(nc)
            return x, aux, outs

        def scan_group(x, aux, gp):
            """One scan group without a cache: (x, aux) after it."""
            return run(x, aux, gp, self.sb, None, cfg.moe is not None)[:2]

        if self.pre:
            x, aux, outs = run(x, aux, params["prelude"], self.pre,
                               cache["prelude"] if cache is not None
                               else None, False)
            if cache is not None:
                new_cache["prelude"] = outs
        if self.n_scan:
            remat = (cache is None and torch.is_grad_enabled()
                     and cfg.remat != "none")
            outs = []
            for i in range(self.n_scan):
                gp = self._pin_group([tree_map(lambda t: t[i], blocks)
                                      for blocks in params["scan"]])
                if remat:
                    # the reference's jax.checkpoint of each scan group:
                    # the backward keeps only the group's inputs
                    x, aux = checkpoint(scan_group, x, aux, gp,
                                        use_reentrant=False)
                elif cache is None:
                    x, aux = scan_group(x, aux, gp)
                else:
                    x, aux, o = run(x, aux, gp, self.sb, cache["scan"][i],
                                    cfg.moe is not None)
                    outs.append(o)
                if after_group is not None:
                    after_group(i, x)
            if cache is not None:
                new_cache["scan"] = outs
        if self.post:
            x, aux, outs = run(x, aux, params["postlude"], self.post,
                               cache["postlude"] if cache is not None
                               else None, False)
            if cache is not None:
                new_cache["postlude"] = outs
        return x, new_cache, aux

    # ------------------------------------------------------------ public
    def forward(self, params, tokens, prefix_embeds=None):
        """Forward: tokens (B, S) -> (logits (B, S(+px), V), aux)."""
        x = self._embed(params, tokens, prefix_embeds)
        x, _, aux = self._stack_walk(params, x, None)
        return self._head(params, x), aux

    def prefill(self, params, tokens, cache, prefix_embeds=None,
                donate: bool = False):
        """Returns (logits_last (B, 1, V), cache').  ``donate``: cache' is
        ``cache``'s tensors, written in place (and a new ``len``)."""
        x = self._embed(params, tokens, prefix_embeds)
        x, new_cache, _ = self._stack_walk(params, x, cache, donate=donate)
        new_cache["len"] = cache["len"] + x.shape[1]
        return self._head(params, x[:, -1:]), new_cache

    def decode_step(self, params, token, cache, donate: bool = False):
        """token (B,) int -> (logits (B, 1, V), cache').  ``donate`` as
        in ``prefill``."""
        x = self._embed(params, token[:, None])
        if self.rules.mesh is not None:
            x = self.rules.act(x, None, None, "dp")     # 2D decode layout
        x, new_cache, _ = self._stack_walk(params, x, cache, donate=donate)
        new_cache["len"] = cache["len"] + 1
        return self._head(params, x), new_cache


def build_model(cfg: ModelConfig, rules: ShardingRules | None = None,
                device=None) -> Model:
    return Model(cfg, device, rules)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the shapes alone (``meta`` device: no
    allocation)."""
    total = 0

    def visit(tree, names):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, names + [k])
        elif isinstance(tree, list):
            for v in tree:
                visit(v, names + [""])
        else:
            n = int(np.prod(tree.shape))
            if active_only and cfg.moe is not None:
                if "moe" in names and names[-1] in ("wi", "wg", "wo"):
                    n = n * cfg.moe.top_k // cfg.moe.n_experts
            total += n

    visit(Model(cfg, "meta").init(), [])
    return total


def params_from_reference(cfg: ModelConfig, tree, device=None) -> dict:
    """The port's parameters from the reference's pytree as numpy arrays
    (``jax.tree.map(np.asarray, model.init(key))``).  Both packages keep
    scan groups stacked on a leading axis, so the structure carries over
    as is; it is checked leaf by leaf against the port's own shapes and
    dtypes.  bf16 arrays (``ml_dtypes.bfloat16``, which ``from_numpy``
    rejects) carry their bits over through int16."""
    device = resolve_device(device)
    want = Model(cfg, "meta").init()

    def carry(ref, like):
        a = np.asarray(ref)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        if t.shape != like.shape or t.dtype != like.dtype:
            raise ValueError(f"reference leaf {tuple(t.shape)} {t.dtype} is "
                             f"not the port's {tuple(like.shape)} "
                             f"{like.dtype}")
        return t.to(device)

    return tree_map(carry, tree, want)
