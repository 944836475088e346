"""PartitionSpec rules: DP / TP(+EP) / SP / ZeRO over a device mesh, as
DTensor placements.

Logical axes
------------
- ``dp``   - batch data parallelism: ("data",) or ("pod", "data").
- ``tp``   - tensor/expert parallelism: "model" (heads, d_ff, vocab,
             experts; sequence dim of decode caches).
- ``fsdp`` - parameter/optimizer-state sharding (ZeRO): the batch axes.

The rules are the reference's (``repro.distributed.sharding``), name-based
over parameter tree paths (the port's params keep the reference's dict
and list layout, so one table covers all ten architectures).  A spec
``P`` names mesh axes per tensor dim (``None``, an axis name, or a tuple
of names); ``placements`` turns it into a DTensor placements list, one
entry per mesh dim.  An entry naming two mesh axes (``("pod", "data")``)
shards that tensor dim over both, the first axis major, as JAX lays it
out.  Spec functions need only the mesh's axis names and sizes
(``MeshShape`` stands in for a mesh without a process group); placing a
tensor needs a ``DeviceMesh``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.utils._pytree as pytree
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

__all__ = ["ShardingRules", "make_rules", "param_pspecs", "cache_pspecs",
           "batch_pspecs", "shardings_for", "enforce_divisibility",
           "placements", "distribute", "P", "GradSpec", "MeshShape",
           "mesh_sizes", "tree_map_with_path", "shard_map", "local_bytes",
           "shardings_of"]


class P(tuple):
    """A partition spec: per tensor dim ``None``, a mesh axis name, or a
    tuple of names (``jax.sharding.PartitionSpec``'s entries; as there, a
    one-name tuple is that name and an empty one is None)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices: enough for every
    spec function (the reference's ``AbstractMesh``)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, a ``MeshShape`` or any
    object with a dict ``shape``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def placements(spec, mesh, ndim: int | None = None) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(i)`` where tensor dim ``i``'s entry names that mesh axis, else
    ``Replicate()``.  ``ndim``: the tensor's rank (the spec may be
    shorter; missing entries are ``None``)."""
    names = _axis_names(mesh)
    spec = tuple(spec)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} is longer than rank {ndim}")
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            # DTensor shards one tensor dim over several mesh dims major
            # to minor in mesh order; another order has no placement
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for p in pos:
            if out[p] != Replicate():
                raise ValueError(f"mesh axis {names[p]} named twice in "
                                 f"{spec}")
            out[p] = Shard(i)
    return out


@dataclass(frozen=True)
class ShardingRules:
    mesh: object | None
    dp: tuple = ("data",)          # batch axes
    tp: str | None = "model"       # tensor-parallel axis
    fsdp: tuple | str | None = "data"  # ZeRO param/opt-state axes (None = off)
    seq_shard_decode: bool = True  # shard decode caches over tp on seq
    sp: bool = True                # Megatron-style sequence parallelism:
    #                                residual stream sharded over tp on seq
    #                                between blocks

    # -------------------------------------------------------- activations
    def act(self, x, *axes):
        """The reference's ``with_sharding_constraint`` with logical axis
        names ('dp' | 'tp' | None per dim): ``x`` redistributed to the
        spec's placements.  Identity without a mesh; a plain tensor under
        a mesh is an error (it would quietly stay unsharded)."""
        if self.mesh is None:
            return x
        if not isinstance(x, DTensor):
            raise TypeError(f"act{axes}: a plain tensor under a mesh")
        return x.redistribute(self.mesh,
                              placements(self.spec(*axes), self.mesh,
                                         x.dim()))

    def spec(self, *axes) -> P:
        return P(*[self._ax(a) for a in axes])

    def named(self, *axes) -> tuple:
        """(mesh, placements) of the spec: the reference's
        ``NamedSharding``."""
        return self.mesh, placements(self.spec(*axes), self.mesh)

    def _ax(self, a):
        if a is None:
            return None
        if a == "dp":
            return self.dp if len(self.dp) > 1 else self.dp[0]
        if a == "tp":
            return self.tp
        if a == "fsdp":
            return self.fsdp
        return a


def make_rules(mesh, *, fsdp: bool = True, seq_shard_decode: bool = True,
               sp: bool = True) -> ShardingRules:
    if mesh is None:
        return ShardingRules(None)
    names = _axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names) or (names[0],)
    tp = "model" if "model" in names else None
    fs = dp if fsdp else None          # ZeRO across every batch axis
    return ShardingRules(mesh, dp, tp, fs, seq_shard_decode, sp)


# ------------------------------------------------------------------ params
# Rule table: (path suffix match) -> spec on (shape, rules).
# Leading layer-stack dims (from scan stacking) are detected by rank and
# left unsharded.

def _leaf_spec(path: tuple[str, ...], ndim_extra: int,
               r: ShardingRules) -> P:
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    gp = path[-3] if len(path) >= 3 else ""
    d, m = r.fsdp, r.tp

    def pad(*dims):
        return P(*([None] * ndim_extra), *dims)

    # ---- embeddings / heads
    if name == "embedding":
        return pad(m, d)                      # (V, D)
    if name == "lm_head":
        return pad(d, m)                      # (D, V)
    if name == "prefix_proj":
        return pad(d, None)

    # ---- biases / norms / scalars
    if name in ("scale", "bias", "b"):
        if parent in ("wq", "wk", "wv", "wi", "wg"):
            return pad(m)                     # TP-column bias
        return pad(None)
    if name in ("A_log", "dt_bias", "D_skip", "lam"):
        return pad(m)

    # ---- MoE
    if parent == "router":
        return pad(None, None)                # (D, E) fp32, replicated
    if gp == "moe" or parent == "moe":
        if name == "wi" or name == "wg":
            return pad(m, d, None)            # (E, D, F)
        if name == "wo":
            return pad(m, None, d)            # (E, F, D)

    # ---- MLA projections
    if parent in ("wkv_a", "wq_a"):
        return pad(d, None)
    if parent in ("wq_b", "wk_b", "wv_b"):
        return pad(d, m)

    # ---- SSD / RG-LRU
    if parent in ("wB", "wC", "wdt"):
        return pad(d, None)
    if parent in ("conv_B", "conv_C"):
        return pad(None, None)
    if parent == "conv_x" or parent == "conv":
        return pad(m, None)                   # depthwise (channels, width)
    if name == "blocks" and parent == "gate":
        return pad(m, None, None)             # block-diagonal gate (H, w, w)

    # ---- generic dense: column-parallel in, row-parallel out
    if parent in ("wq", "wk", "wv", "wi", "wg", "wz", "wx", "wy",
                  "in_proj", "exit_head"):
        return pad(d, m)                      # (D, F)
    if parent in ("wo", "out_proj"):
        return pad(m, d)                      # (F, D)
    if name == "w":
        return pad(d, None)
    return pad()


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = mesh_sizes(mesh)
    n = 1
    for a in entry if isinstance(entry, tuple) else (entry,):
        n *= sizes[a]
    return n


def enforce_divisibility(spec, shape, mesh) -> P:
    """Drop spec axes that do not evenly divide the tensor dim (the
    reference's rule for inputs: uneven padding is priced, not hidden)."""
    fixed = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        fixed.append(entry)
    return P(*fixed)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over nested dicts / lists / tuples; the path is
    the reference's key strings (dict keys, list indices as str).
    NamedTuples keep their type; a ``P`` is a leaf."""
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if tree is None:
        return None
    return fn(path, tree)


def _base_rank(path: tuple[str, ...]) -> int | None:
    """Intrinsic (unstacked) rank of a parameter, from its name."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    gp = path[-3] if len(path) >= 3 else ""
    if name in ("scale", "bias", "b", "A_log", "dt_bias", "D_skip", "lam"):
        return 1
    if name in ("embedding", "lm_head", "prefix_proj"):
        return 2
    if (gp == "moe" or parent == "moe") and name in ("wi", "wg", "wo"):
        return 3
    if parent == "gate" and name == "blocks":
        return 3
    if parent in ("conv_x", "conv", "conv_B", "conv_C"):
        return 2
    return 2            # generic dense kernels


def param_pspecs(params_shape, rules: ShardingRules):
    """Map a parameter tree (tensors of any device, ``meta`` included) to
    ``P`` specs.  Leading stacked-layer dims are inferred from the rank;
    non-divisible dims fall back to replicated."""
    def one(keys, leaf):
        base = _base_rank(keys)
        extra = max(leaf.ndim - base, 0) if base is not None else 0
        spec = _leaf_spec(keys, extra, rules)
        if rules.mesh is not None:
            spec = enforce_divisibility(spec, leaf.shape, rules.mesh)
        return spec

    return tree_map_with_path(one, params_shape)


# natural rank of each cache leaf (a stacked scan cache adds one)
_CACHE_RANK = {"ckv": 3, "krope": 3, "k": 4, "v": 4, "h": 2, "state": 4,
               "conv": 3}


def cache_pspecs(cache_shape, cfg, rules: ShardingRules):
    """Specs for decode / prefill caches.  KV and latent caches shard
    their sequence dim over tp (flash-decode style) and batch over dp;
    small windowed / recurrent states shard batch only.  A cache leaf
    under ``scan`` with a leading stacked dim (the reference's layout)
    keeps that dim unsharded; the port's per-group caches have none."""
    dp = rules.dp if len(rules.dp) > 1 else (rules.dp[0]
                                             if rules.dp else None)
    m = rules.tp if rules.seq_shard_decode else None

    def one(keys, leaf):
        name = keys[-1]
        extra = leaf.ndim - _CACHE_RANK.get(name, leaf.ndim)
        lead = (None,) * extra if "scan" in keys else ()
        if name == "len":
            return P()
        if name in ("ckv", "krope"):            # (B, S, d)
            return P(*lead, dp, m, None)
        if name in ("k", "v"):                  # (B, S, H, Dh)
            if cfg.rglru is not None:           # small window ring
                return P(*lead, dp, None, None, None)
            return P(*lead, dp, m, None, None)
        if name == "h":                         # rglru state (B, W)
            return P(*lead, dp, rules.tp)
        if name == "state":                     # ssd (B, H, N, P)
            return P(*lead, dp, rules.tp, None, None)
        if name == "conv":                      # (B, cw-1, C)
            return P(*lead, dp, None, rules.tp)
        return P(*lead, *([None] * (leaf.ndim - len(lead))))

    def one_checked(keys, leaf):
        spec = one(keys, leaf)
        if rules.mesh is not None:
            spec = enforce_divisibility(spec, leaf.shape, rules.mesh)
        return spec

    return tree_map_with_path(one_checked, cache_shape)


def batch_pspecs(batch_shape, rules: ShardingRules):
    """Input batches: dim 0 (global batch) over dp, rest replicated."""
    dp = rules.dp if len(rules.dp) > 1 else (rules.dp[0]
                                             if rules.dp else None)

    def one(_keys, leaf):
        spec = P(dp, *([None] * (leaf.ndim - 1)))
        if rules.mesh is not None:
            spec = enforce_divisibility(spec, leaf.shape, rules.mesh)
        return spec

    return tree_map_with_path(one, batch_shape)


def shardings_for(params_shape, rules: ShardingRules):
    """``(mesh, placements)`` per parameter (None without a mesh): what
    ``restore_checkpoint(..., shardings=)`` and ``distribute`` take."""
    if rules.mesh is None:
        return None
    return tree_map_with_path(
        lambda _k, s: (rules.mesh, placements(s, rules.mesh)),
        param_pspecs(params_shape, rules))


def distribute(tree, specs, mesh):
    """Each tensor of ``tree`` (whole, the same on every rank) as a
    DTensor placed by its spec in ``specs`` (a matching tree of ``P``).
    0-dim leaves are replicated."""
    def one(_keys, t):
        spec = _spec_at(specs, _keys)
        return distribute_tensor(t, mesh, placements(spec, mesh, t.dim()))
    return tree_map_with_path(one, tree)


def _spec_at(specs, keys):
    node = specs
    for k in keys:
        node = node[k] if isinstance(node, dict) else node[int(k)]
    return node


def local_bytes(tree) -> int:
    """Bytes of this rank's shards (a plain tensor counts whole)."""
    total = 0

    def one(_k, t):
        nonlocal total
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    tree_map_with_path(one, tree)
    return total


def shardings_of(tree):
    """``(mesh, placements)`` of each DTensor leaf of ``tree``; None for a
    plain tensor (what ``restore_checkpoint(..., shardings=)`` takes)."""
    return tree_map_with_path(
        lambda _k, t: ((t.device_mesh, list(t.placements))
                       if isinstance(t, DTensor) else None), tree)


@dataclass(frozen=True)
class GradSpec:
    """An input's gradient layout in ``shard_map``: its spec, and the
    mesh axes over which each rank's local gradient is a partial sum (the
    input was replicated there and each rank used a part of it)."""
    spec: P
    partial: tuple = ()


def _is_spec(x) -> bool:
    return isinstance(x, (P, GradSpec))


def _grad_placements(g, mesh) -> tuple:
    if isinstance(g, P):
        return tuple(placements(g, mesh))
    out = placements(g.spec, mesh)
    names = _axis_names(mesh)
    for a in g.partial:
        i = names.index(a)
        if out[i] != Replicate():
            raise ValueError(f"{a} both shards and sums {g}")
        out[i] = Partial()
    return tuple(out)


def shard_map(fn, mesh, in_specs, out_specs, in_grad_specs=None):
    """The reference's ``shard_map``: ``fn`` on each rank's local shards,
    its DTensor arguments (trees of them, one tree per positional
    argument) redistributed to ``in_specs`` first and its outputs placed
    by ``out_specs`` (``local_map`` underneath).  ``in_grad_specs``: the
    inputs' gradient layouts (``P`` or ``GradSpec``; default: as the
    inputs).  Every tensor argument must be a DTensor."""
    def flat(specs, conv):
        # a None argument (no cache) has a None spec
        leaves = pytree.tree_flatten(specs, is_leaf=_is_spec)[0]
        return tuple(conv(s) if s is not None else None for s in leaves)

    ins = flat(in_specs, lambda s: tuple(placements(s, mesh)))
    outs = flat(out_specs, lambda s: tuple(placements(s, mesh)))
    grads = (flat(in_grad_specs, lambda s: _grad_placements(s, mesh))
             if in_grad_specs is not None else None)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)
