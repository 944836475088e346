"""Dry-run cells: (architecture x input shape x mesh) -> (step
function, DTensor inputs of fake tensors).

``input_specs`` builds every step input as a DTensor whose local shard is
a fake tensor (``FakeTensorMode``: shapes, dtypes and devices, no
memory), placed by the ported specs.  Call it, and the step, inside one
active ``FakeTensorMode`` on a mesh over the fake process group
(``dryrun.py``).  The full published configs are exercised only this
way.

Per shape kind:
- train_*   -> ``train_step(state, batch)`` (forward + backward + AdamW)
- prefill_* -> ``prefill_step(params, tokens, cache)``
- decode_* / long_* -> ``decode_step(params, token, cache)``: one new
  token against a seq_len-deep cache (the spec's ``serve_step``).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..configs import get_config, SHAPES, ShapeSpec
from ..configs.base import ModelConfig
from ..distributed.sharding import (P, batch_pspecs, cache_pspecs,
                                    enforce_divisibility, make_rules,
                                    param_pspecs, placements,
                                    tree_map_with_path)
from ..launch.mesh import mesh_chips
from ..models import Model
from ..optim.adamw import AdamWState
from ..serve import make_decode_step, make_prefill_step
from ..train import TrainState, make_train_step

__all__ = ["cell_applicable", "build_cell", "input_specs", "CELL_SKIPS",
           "default_microbatch"]

# long_500k runs only on sub-quadratic archs (full-attention KV at 500k
# is exactly what the shape excludes)
CELL_SKIPS = {
    ("deepseek-v2-236b", "long_500k"): "full-attention (MLA) 500k cache",
    ("qwen3-moe-235b-a22b", "long_500k"): "full-attention 500k cache",
    ("stablelm-1.6b", "long_500k"): "full-attention 500k cache",
    ("olmo-1b", "long_500k"): "full-attention 500k cache",
    ("qwen2-72b", "long_500k"): "full-attention 500k cache",
    ("llama3-405b", "long_500k"): "full-attention 500k cache",
    ("internvl2-1b", "long_500k"): "full-attention 500k cache",
    ("musicgen-medium", "long_500k"): "full-attention 500k cache",
}


def cell_applicable(arch: str, shape: str) -> bool:
    return (arch, shape) not in CELL_SKIPS


def _moment_dtype(cfg: ModelConfig):
    # 405B-class: bf16 Adam moments to fit the HBM budget
    return torch.bfloat16 if cfg.n_params() > 3e11 else torch.float32


def _accum_dtype(cfg: ModelConfig):
    # grad-accumulation buffer is param-sized: bf16 for 405B-class
    return torch.bfloat16 if cfg.n_params() > 3e11 else torch.float32


def default_microbatch(cfg: ModelConfig, spec: ShapeSpec, chips: int,
                       tp: int = 16, budget_bytes: float = 2 * 2 ** 30
                       ) -> int:
    """Largest divisor of the global batch whose per-device scan-carry
    (seq x d_model x n_layers x 2 B, SP-sharded by tp) fits the budget.
    0 = no accumulation needed."""
    if spec.kind != "train":
        return 0
    dp = max(chips // tp, 1)
    per_tok = cfg.d_model * 2 * max(len(cfg.block_pattern), 1)
    fit = int(budget_bytes * dp * tp // (spec.seq_len * per_tok))
    if fit >= spec.global_batch:
        return 0
    mb = max(dp, 1)
    for d in range(spec.global_batch, 0, -1):
        if spec.global_batch % d == 0 and d <= fit and d % dp == 0:
            mb = d
            break
    return mb


def _fake_dtensor(shape, dtype, spec, mesh, device):
    """A DTensor of ``shape`` placed by ``spec`` (dropping axes that do
    not divide), its local shard a new tensor in the active fake mode."""
    spec = enforce_divisibility(spec, shape, mesh)
    pl = placements(spec, mesh, len(shape))
    local = list(shape)              # every sharded dim divides evenly
    for p, n in zip(pl, mesh.shape):
        if p.is_shard():
            local[p.dim] //= n
    t = torch.empty(local, dtype=dtype, device=device)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def _placed(tree, specs, mesh, device, dtype=None):
    """``tree`` (meta tensors) as fake DTensors placed by ``specs``."""
    def one(keys, t):
        node = specs
        for k in keys:
            node = node[k] if isinstance(node, dict) else node[int(k)]
        return _fake_dtensor(tuple(t.shape), dtype or t.dtype, node, mesh,
                             device)
    return tree_map_with_path(one, tree)


def input_specs(arch: str, shape: str, mesh, *, cfg: ModelConfig = None,
                fsdp: bool = True) -> dict:
    """Fake DTensor stand-ins for every step input (call inside an active
    ``FakeTensorMode``), their local shards on the mesh's device type."""
    cfg = cfg or get_config(arch)
    spec: ShapeSpec = SHAPES[shape]
    rules = make_rules(mesh, fsdp=fsdp)
    device = mesh.device_type
    dp = rules.dp if len(rules.dp) > 1 else rules.dp[0]
    meta = Model(cfg, "meta")
    B, S = spec.global_batch, spec.seq_len
    params_shape = meta.init()
    cache = meta.init_cache(B, S) if spec.kind != "train" else None
    p_specs = param_pspecs(params_shape, rules)

    if spec.kind == "train":
        params = _placed(params_shape, p_specs, mesh, device)
        md = _moment_dtype(cfg)
        moments = [_placed(params_shape, p_specs, mesh, device, md)
                   for _ in range(2)]
        zero = torch.zeros((), dtype=torch.int32, device=device)
        state = TrainState(params, AdamWState(zero, *moments), zero.clone())
        batch = {"tokens": torch.empty((B, S + 1), dtype=torch.int32,
                                       device="meta")}
        if cfg.input_mode == "tokens+prefix":
            batch["tokens"] = torch.empty(
                (B, S - cfg.n_prefix_embeds + 1), dtype=torch.int32,
                device="meta")
            batch["prefix_embeds"] = torch.empty(
                (B, cfg.n_prefix_embeds, cfg.d_model), dtype=torch.bfloat16,
                device="meta")
        return {"state": state,
                "batch": _placed(batch, batch_pspecs(batch, rules), mesh,
                                 device)}

    out = {"params": _placed(params_shape, p_specs, mesh, device),
           "cache": _placed(cache, cache_pspecs(cache, cfg, rules), mesh,
                            device)}
    if spec.kind == "prefill":
        if cfg.input_mode == "tokens+prefix":
            out["tokens"] = _fake_dtensor((B, S - cfg.n_prefix_embeds),
                                          torch.int32, P(dp), mesh, device)
            out["prefix_embeds"] = _fake_dtensor(
                (B, cfg.n_prefix_embeds, cfg.d_model), torch.bfloat16,
                P(dp, None, None), mesh, device)
        else:
            out["tokens"] = _fake_dtensor((B, S), torch.int32, P(dp), mesh,
                                          device)
        return out
    out["token"] = _fake_dtensor((B,), torch.int32, P(dp), mesh, device)
    return out


def build_cell(arch: str, shape: str, mesh, *, cfg: ModelConfig = None,
               fsdp: bool = True, microbatch: int = 0):
    """Returns ``(step_fn, inputs)``; ``step_fn(**inputs)`` under the
    active fake mode is the dry-run contract.  The step writes its train
    state (a train shape) or its cache (a serving shape) in place, as the
    reference's dry run donates them."""
    cfg = cfg or get_config(arch)
    rules = make_rules(mesh, fsdp=fsdp)
    model = Model(cfg, mesh.device_type, rules)
    spec = SHAPES[shape]
    inputs = input_specs(arch, shape, mesh, cfg=cfg, fsdp=fsdp)
    if spec.kind == "train":
        if microbatch == 0:
            microbatch = default_microbatch(cfg, spec, mesh_chips(mesh))
        fn = make_train_step(model, microbatch=microbatch,
                             accum_dtype=_accum_dtype(cfg), donate=True)

        def train_fn(state, batch):
            return fn(state, batch)
        return train_fn, inputs
    if spec.kind == "prefill":
        pf = make_prefill_step(model, donate=True)
        if cfg.input_mode == "tokens+prefix":
            def prefill_fn(params, tokens, cache, prefix_embeds):
                return pf(params, tokens, cache, prefix_embeds)
        else:
            def prefill_fn(params, tokens, cache):
                return pf(params, tokens, cache)
        return prefill_fn, inputs
    dc = make_decode_step(model, donate=True)

    def decode_fn(params, token, cache):
        return dc(params, token, cache)
    return decode_fn, inputs
