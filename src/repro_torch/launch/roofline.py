"""Roofline analysis of a traced step (the reference's
``launch/roofline.py`` for an eager PyTorch trace).

Three terms per (arch x shape x mesh), at H100 SXM constants:

    compute    = FLOPs / (chips * 989e12)            [bf16 dense peak]
    memory     = HBM bytes / (chips * 3.35e12)
    collective = collective bytes per chip / 450e9   [NVLink 4, one way]

FLOPs and HBM bytes come from the reference's exact analytic model of
the config (``analytic_cost``, copied as it is: plain config
arithmetic).  The port has no HLO, so the reference's
``collective_bytes_from_text`` has no counterpart: ``CollectiveCounter``
records every c10d functional collective the traced step runs, with
its tensor bytes times the ring factor, by kind.  A Python loop runs
its collectives once per iteration, so no trip count is needed.

The reference's per-device counts from XLA's cost analysis
(``xla_flops_per_device``, ``xla_bytes_per_device``) come here from
``LocalCost``, which watches one rank's local operations as they
dispatch: FLOPs from ``torch.utils.flop_counter``'s formula registry
(matrix products, convolutions, attention; elementwise operations count
none), bytes as each operation's operands plus outputs (views move
none).  They are not XLA's numbers: nothing is fused, so every
intermediate a fusion would keep in registers is counted as written and
read again; and every iteration of a Python loop (the layer groups, the
microbatches) is counted, where XLA's cost analysis counts the body of a
``while`` loop (the reference's scan over layers) once.
"""

from __future__ import annotations

import weakref

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import get_config, SHAPES
from ..configs.base import ModelConfig, ShapeSpec

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CollectiveCounter",
           "LocalCost", "analytic_cost", "roofline_from_trace",
           "model_flops"]

PEAK_FLOPS = 989e12   # bf16 dense FLOP/s per H100 SXM (NVIDIA data sheet)
HBM_BW = 3.35e12      # HBM3 bytes/s per H100 SXM (NVIDIA data sheet)
LINK_BW = 450e9       # NVLink 4 bytes/s per direction per H100 (data sheet:
#                       900 GB/s total bidirectional)

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16}

# ring-algorithm byte factors per element of the named tensor
_COLL_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


# c10d functional collectives (the ops DTensor and ``funcol`` call) by
# the reference's kind names
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


class CollectiveCounter(TorchDispatchMode):
    """Counts the bytes of every c10d functional collective dispatched
    while it is active (``with CollectiveCounter() as cc: ...``).  A
    collective's bytes are its result tensor's (per device), as the
    reference prices an HLO op by its result shape, times
    ``_COLL_FACTOR``.

    ``result()`` gives the reference's keys: ``total_bytes``, ``per_kind``
    and ``n_ops``.  ``total_bytes_norm`` equals ``total_bytes``: the
    reference re-priced widened f32 collectives at bf16 because XLA's CPU
    backend widens bf16 products, which an eager trace does not do."""

    def __init__(self):
        super().__init__()
        self.per_kind: dict[str, float] = {}
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", "")
        name = func._schema.name.split("::")[-1]
        kind = _FUNCOL_KIND.get(name) if ns == "_c10d_functional" else None
        if kind is not None:
            tensors = out if isinstance(out, (list, tuple)) else [out]
            b = sum(x.numel() * x.element_size() for x in tensors)
            self.per_kind[kind] = (self.per_kind.get(kind, 0.0)
                                   + b * _COLL_FACTOR[kind])
            self.n_ops += 1
        return out

    def result(self) -> dict:
        total = float(sum(self.per_kind.values()))
        return {"total_bytes": total, "total_bytes_norm": total,
                "per_kind": dict(self.per_kind), "n_ops": self.n_ops}


class LocalCost(TorchDispatchMode):
    """One rank's local operations, counted as they dispatch: the peak
    bytes they hold at once, their FLOPs and their bytes accessed.

    The peak counts each storage once while it lives: the external
    tensors given (the inputs' local shards), then every output of a
    local operation that belongs to ``fake_mode`` (the step's fake
    shards) or is a real host tensor.  A buffer written in place is the
    same storage, counted once.  FLOPs (``flop_registry``'s formulas) and
    bytes (each distinct operand once plus each output once: an in-place
    update reads and writes its buffer; none for a view) count the
    operations whose outputs are such tensors.
    DTensor-level operations pass through to DTensor, whose sharding
    propagation computes its global-shape metadata in a fake mode of its
    own: those tensors are not this rank's memory or work and are not
    counted.  (``torch.distributed._tools.mem_tracker.MemTracker`` counts
    them too in torch 2.11, which has no means to tell the two apart.)"""

    def __init__(self, fake_mode, external=()):
        super().__init__()
        self.fake_mode = fake_mode
        self.live: dict = {}
        self.now = self.peak = 0
        self.flops = 0
        self.bytes_accessed = 0
        for t in external:
            self._hold(t)

    def _mine(self, t) -> bool:
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return False
        return (t.fake_mode is self.fake_mode if isinstance(t, FakeTensor)
                else True)

    def _hold(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += self.live[key]
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor desugars to local ops
        kwargs = kwargs or {}
        return self.count(func, args, kwargs, func(*args, **kwargs))

    def count(self, func, args, kwargs, out):
        """Count one operation's result ``out``; returns it."""
        outs = [t for t in pytree.tree_leaves(out) if self._mine(t)]
        if not outs:
            return out
        for t in outs:
            self._hold(t)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            for group in (pytree.tree_leaves((args, kwargs)), outs):
                seen = {id(t): t for t in group
                        if isinstance(t, torch.Tensor)}
                self.bytes_accessed += sum(t.numel() * t.element_size()
                                           for t in seen.values())
        return out


# ------------------------------------------------------------- analytic cost
def model_flops(cfg: ModelConfig, tokens: int) -> float:
    """6*N*D-style training FLOPs (MoE: active params only), no attention."""
    return 6.0 * cfg.n_active_params() * tokens


def _attn_flops_per_layer(cfg, B, S, causal=True, decode=False,
                          window=None):
    """Score+PV matmul FLOPs for one attention layer (fwd)."""
    if cfg.mla is not None:
        dh = cfg.mla.nope_dim + cfg.mla.rope_dim
        dv = cfg.mla.v_dim
    else:
        dh = dv = cfg.head_dim_
    H = cfg.n_heads
    if decode:
        kv = min(S, window) if window else S
        return 2.0 * B * H * kv * (dh + dv)
    kv = min(S, window) if window else S
    eff = kv / 2 if (causal and not window) else kv
    return 2.0 * B * H * S * eff * (dh + dv)


def _ssd_flops_per_layer(cfg, B, S, decode=False):
    s = cfg.ssd
    din = s.expand * cfg.d_model
    H = din // s.head_dim
    N, Pd = s.d_state, s.head_dim
    if decode:
        return 2.0 * B * H * N * Pd * 2
    L = s.chunk
    intra = 2.0 * B * S * L * H * (N + Pd)     # CBᵀ + att*x per chunk row
    inter = 2.0 * B * S * H * N * Pd * 2       # state build + apply
    return intra + inter


def analytic_cost(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """Exact FLOPs + HBM bytes for the cell's step (per step, whole fleet).

    train: fwd+bwd (3xfwd matmul FLOPs) + remat refwd (+1x) + optimizer;
    prefill: fwd over B*S tokens; decode: fwd over B tokens + cache scan.
    """
    B, S = spec.global_batch, spec.seq_len
    N_act = cfg.n_active_params()
    N_tot = cfg.n_params()
    pat = cfg.block_pattern
    window = cfg.rglru.window if cfg.rglru is not None else None

    def fwd_flops(tokens, decode=False):
        f = 2.0 * N_act * tokens
        Bx = B
        Sx = 1 if decode else tokens // B
        for kind in pat:
            if kind == "attn":
                f += _attn_flops_per_layer(cfg, Bx, S if decode else Sx,
                                           decode=decode, window=window)
            elif kind == "ssd":
                f += _ssd_flops_per_layer(cfg, Bx, Sx, decode=decode)
            elif kind == "rglru":
                f += 10.0 * Bx * Sx * cfg.rglru.width   # elementwise scan
        return f

    pb = 2 if cfg.param_dtype == "bfloat16" else 4
    N_res = N_tot          # resident weights read once per step (MoE: all
    #                        experts compute their capacity slice)
    if spec.kind == "train":
        T = B * S
        flops = 4.0 * fwd_flops(T)        # fwd + bwd(2x) + remat refwd(1x)
        mdtype = 2 if N_tot > 3e11 else 4
        bytes_params = N_tot * (pb * 3            # fwd read, bwd read, write
                                + pb              # grad
                                + 2 * mdtype * 2)  # m, v read+write
        bytes_act = 2.0 * T * cfg.d_model * len(pat) * 2 * 2  # remat blocks
        bytes_ = bytes_params + bytes_act
    elif spec.kind == "prefill":
        T = B * S
        flops = fwd_flops(T)
        bytes_ = N_res * pb + 2.0 * T * cfg.d_model * len(pat) * 2 \
            + T * _cache_bytes_per_token(cfg)
    else:                                  # decode: one token per sequence
        flops = fwd_flops(B, decode=True)
        bytes_ = N_res * pb + B * S * _cache_bytes_per_token(cfg) \
            + B * _cache_bytes_per_token(cfg)
    return {"flops": flops, "hbm_bytes": bytes_}


def _cache_bytes_per_token(cfg: ModelConfig) -> float:
    """Decode-state bytes read per token of context, summed over layers."""
    total = 0.0
    for kind in cfg.block_pattern:
        if kind == "attn":
            if cfg.mla is not None:
                total += (cfg.mla.kv_lora + cfg.mla.rope_dim) * 2
            else:
                w = cfg.rglru.window if cfg.rglru is not None else None
                # windowed layers hold ≤ window entries; amortize as full
                total += 2 * cfg.n_kv_heads * cfg.head_dim_ * 2 \
                    * (1.0 if w is None else 0.0)
        # rglru/ssd state is O(1) per sequence — negligible per token
    return total


# ----------------------------------------------------------------- assemble
def roofline_from_trace(arch: str, shape: str, chips: int,
                        collective: dict, local: LocalCost,
                        cfg: ModelConfig | None = None) -> dict:
    """The reference's ``roofline_from_compiled`` keys from a traced step:
    the analytic FLOPs and bytes, the counted collective bytes per chip,
    and under the reference's ``xla_flops_per_device`` /
    ``xla_bytes_per_device`` the step's local FLOPs and bytes accessed
    counted by ``local`` (not XLA's counts, see the module docstring).
    The trace's own collective count is ``collective_ops``."""
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape]
    ana = analytic_cost(cfg, spec)
    t_compute = ana["flops"] / (chips * PEAK_FLOPS)
    t_memory = ana["hbm_bytes"] / (chips * HBM_BW)
    t_coll = collective["total_bytes"] / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(cfg, spec.tokens if spec.kind == "train"
                     else (spec.tokens if spec.kind == "prefill"
                           else spec.global_batch))
    if spec.kind != "train":
        mf = mf / 3.0                                # fwd only: 2*N*D
    useful = mf / max(ana["flops"], 1.0)
    frac = t_compute / max(bound, 1e-30)             # roofline fraction
    return {
        **{k: float(v) for k, v in terms.items()},
        "dominant": dominant,
        "step_time_bound_s": float(bound),
        "roofline_fraction": float(frac),
        "analytic_flops": float(ana["flops"]),
        "analytic_hbm_bytes": float(ana["hbm_bytes"]),
        "model_flops_6ND": float(mf),
        "useful_flops_ratio": float(useful),
        "xla_flops_per_device": float(local.flops),
        "xla_bytes_per_device": float(local.bytes_accessed),
        "collective_ops": int(collective["n_ops"]),
        "collective_bytes_per_device": float(collective["total_bytes"]),
        "collective_bytes_bf16_norm": float(collective["total_bytes"]),
    }
