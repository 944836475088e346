"""The port's sharding rules and launch layer against the reference's, in
one process (no process group except a fake one in one test):

- ``param_pspecs``, ``cache_pspecs`` and ``batch_pspecs`` equal the
  reference's entry for entry for all ten published configs on both
  production meshes, with ZeRO on and off (the reference on an
  ``AbstractMesh`` over ``jax.eval_shape``; the port on ``meta`` tensors
  and a ``MeshShape``);
- ``enforce_divisibility`` and the spec-to-placements function;
- the 40-cell matrix with its 8 skips, ``default_microbatch``,
  ``analytic_cost`` and ``model_flops`` equal to the reference's for
  every cell, exactly;
- ``CollectiveCounter`` on a fake 8-rank world gives the reference HLO
  parser's totals for the same collectives run eagerly;
- ``LocalCost`` on a two-matmul step of fake tensors: 2 m n k FLOPs per
  product, each product's operand and output bytes, the peak of what is
  held, a buffer written in place counted once;
- dry-run cells in subprocesses (olmo on both meshes; MLA, RG-LRU and
  SSD decode on (16, 16)): ``ok``, their argument bytes the sum of their
  inputs' local shards, ``flops`` and ``bytes_accessed`` counted (numbers,
  also under the roofline's ``xla_*_per_device`` keys), and the donated
  KV cache counted once (olmo: the step's temporaries less than the
  cache's local bytes).
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.distributed import sharding as r_sh  # noqa: E402
from repro.launch import cells as r_cells  # noqa: E402
from repro.launch import roofline as r_roof  # noqa: E402
from repro.models import build_model as r_build  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.distributed import sharding as t_sh  # noqa: E402
from repro_torch.distributed.sharding import MeshShape, P  # noqa: E402
from repro_torch.launch import cells as t_cells  # noqa: E402
from repro_torch.launch import roofline as t_roof  # noqa: E402
from repro_torch.models import Model  # noqa: E402

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the cache specs at decode_32k's batch and depth
CACHE_B, CACHE_S = 128, 32768


@functools.lru_cache(maxsize=None)
def ref_shapes(arch: str):
    cfg = r_configs.get_config(arch)
    model = r_build(cfg)
    params = jax.eval_shape(model.init, jax.random.key(0))
    cache = jax.eval_shape(lambda: model.init_cache(CACHE_B, CACHE_S))
    return cfg, params, cache


def ref_table(tree) -> dict:
    """{path: spec entries} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "idx", None)))
                  for k in path): tuple(s) for path, s in flat}


def port_table(tree) -> dict:
    out = {}
    t_sh.tree_map_with_path(lambda k, s: out.__setitem__(k, tuple(s)), tree)
    return out


def meta_like(tree):
    """The reference's shape tree as ``meta`` tensors (lists for its
    lists, dicts for its dicts)."""
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [meta_like(v) for v in tree]
    return torch.empty(tree.shape, device="meta")


def rules_pair(mesh: str, fsdp: bool):
    sizes, names = MESHES[mesh]
    return (r_sh.make_rules(AbstractMesh(sizes, names), fsdp=fsdp),
            t_sh.make_rules(MeshShape(names, sizes), fsdp=fsdp))


@pytest.mark.parametrize("fsdp", [True, False], ids=["zero", "nozero"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", t_configs.list_archs())
def test_spec_tables_equal_reference(arch, mesh, fsdp):
    cfg_r, params_r, cache_r = ref_shapes(arch)
    rr, rt = rules_pair(mesh, fsdp)
    cfg_t = t_configs.get_config(arch)
    meta = Model(cfg_t, "meta")

    want = ref_table(r_sh.param_pspecs(params_r, rr))
    got = port_table(t_sh.param_pspecs(meta.init(), rt))
    assert got == want

    # caches: on the reference's stacked layout, entry for entry; on the
    # port's per-group layout, the same specs without the stacked dim
    want_c = ref_table(r_sh.cache_pspecs(cache_r, cfg_r, rr))
    assert port_table(t_sh.cache_pspecs(meta_like(cache_r), cfg_t, rt)) \
        == want_c
    own = port_table(t_sh.cache_pspecs(meta.init_cache(CACHE_B, CACHE_S),
                                       cfg_t, rt))
    for path, spec in own.items():
        if path[0] == "scan":            # ("scan", group, block, name)
            assert spec == want_c[("scan", path[2], path[3])][1:], path
        else:
            assert spec == want_c[path], path

    batch = {"tokens": jax.ShapeDtypeStruct((256, 4097), np.int32),
             "prefix_embeds": jax.ShapeDtypeStruct((256, 7, 64), np.float32),
             "odd": jax.ShapeDtypeStruct((17, 3), np.int32)}
    assert port_table(t_sh.batch_pspecs(meta_like(batch), rt)) \
        == ref_table(r_sh.batch_pspecs(batch, rr))


class FakeMesh:
    shape = {"data": 16, "model": 16}


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (32, 48)), (("data", None), (17, 48)),
    ((("data", "model"),), (256,)), ((("data", "model"),), (136,)),
    (("model", "data", None), (16, 7, 3)), ((None, "model"), (5, 32))])
def test_enforce_divisibility_equals_reference(spec, shape):
    want = r_sh.enforce_divisibility(JP(*spec), shape, FakeMesh())
    got = t_sh.enforce_divisibility(P(*spec), shape, FakeMesh())
    assert tuple(got) == tuple(want)
    assert tuple(t_sh.enforce_divisibility(
        P(*spec), shape, MeshShape(("data", "model"), (16, 16)))) \
        == tuple(want)


def test_placements_of_specs():
    m3 = MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert t_sh.placements(P(("pod", "data"), "model"), m3) == [
        Shard(0), Shard(0), Shard(1)]
    assert t_sh.placements(P(None, "model"), m3) == [
        Replicate(), Replicate(), Shard(1)]
    assert t_sh.placements(P(), m3) == [Replicate()] * 3
    assert t_sh.placements(P("model", None, ("pod", "data")), m3, 3) == [
        Shard(2), Shard(2), Shard(0)]
    with pytest.raises(ValueError):      # minor axis before the major one
        t_sh.placements(P(("data", "pod")), m3)
    with pytest.raises(ValueError):      # one mesh axis on two dims
        t_sh.placements(P("model", "model"), m3)
    with pytest.raises(ValueError):      # longer than the tensor's rank
        t_sh.placements(P("data", None), m3, 1)
    r = t_sh.make_rules(m3)
    assert r.spec("dp", None, "tp") == P(("pod", "data"), None, "model")
    assert t_sh.make_rules(m3, fsdp=False).fsdp is None
    assert t_sh.make_rules(None).act("x", "dp") == "x"


def test_act_refuses_a_plain_tensor_under_a_mesh():
    r = t_sh.make_rules(MeshShape(("data", "model"), (2, 4)))
    with pytest.raises(TypeError):
        r.act(torch.zeros(2, 3), "dp", None)


def test_cell_matrix_is_40_with_8_documented_skips():
    archs, shapes = t_configs.list_archs(), list(t_configs.SHAPES)
    assert archs == r_configs.list_archs()
    assert shapes == list(r_configs.SHAPES)
    assert t_cells.CELL_SKIPS == r_cells.CELL_SKIPS
    live = [(a, s) for a in archs for s in shapes
            if t_cells.cell_applicable(a, s)]
    assert len(archs) * len(shapes) == 40 and len(live) == 32
    assert live == [(a, s) for a in archs for s in shapes
                    if r_cells.cell_applicable(a, s)]


@pytest.fixture(scope="module")
def counted_once():
    """Each package's parameter counts memoised per config: the cost
    model asks for them per shape, and each count walks the whole
    parameter tree (``eval_shape`` / a ``meta`` init)."""
    from repro.configs.base import ModelConfig as RCfg
    from repro_torch.configs.base import ModelConfig as TCfg
    with pytest.MonkeyPatch.context() as mp:
        for cls in (RCfg, TCfg):
            for name in ("n_params", "n_active_params"):
                mp.setattr(cls, name,
                           functools.lru_cache(maxsize=None)(
                               getattr(cls, name)))
        yield


@pytest.mark.parametrize("arch", t_configs.list_archs())
def test_cells_cost_and_microbatch_equal_reference(arch, counted_once):
    cfg_t, cfg_r = t_configs.get_config(arch), r_configs.get_config(arch)
    for shape in t_configs.SHAPES:
        st, sr = t_configs.SHAPES[shape], r_configs.SHAPES[shape]
        assert t_roof.analytic_cost(cfg_t, st) == r_roof.analytic_cost(
            cfg_r, sr)
        assert t_roof.model_flops(cfg_t, st.tokens) == r_roof.model_flops(
            cfg_r, sr.tokens)
        for chips in (256, 512):
            assert t_cells.default_microbatch(cfg_t, st, chips) \
                == r_cells.default_microbatch(cfg_r, sr, chips)
    assert (t_cells._moment_dtype(cfg_t) == torch.bfloat16) == (
        r_cells._moment_dtype(cfg_r) == jax.numpy.bfloat16)


HLO = """\
ENTRY %main.1 (p0: f32[16,16]) -> f32[16,16] {
  %ag = bf16[64,128]{1,0} all-gather(%x), channel_id=1
  %ar = f32[32]{0} all-reduce(%convert_fusion.1), channel_id=2
  %w = (s32[], f32[4]) while(%tuple), condition=%cond.1, body=%body.1
}
body.1 (p: (s32[], f32[4])) -> (s32[], f32[4]) {
  %rs = bf16[8,8]{1,0} reduce-scatter(%y), channel_id=3
}
cond.1 (p: (s32[], f32[4])) -> pred[] {
  %c = s32[] constant(10)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}
"""


def test_collective_counter_gives_the_reference_parsers_totals():
    """The reference's HLO example run eagerly on a fake 8-rank world:
    a bf16 all-gather to (64, 128), an f32 all-reduce of 32, and a bf16
    reduce-scatter to (8, 8) ten times in a loop."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    want = r_roof.collective_bytes_from_text(HLO)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        group = dist.group.WORLD
        with t_roof.CollectiveCounter() as cc:
            funcol.all_gather_tensor(torch.zeros(8, 128, dtype=torch.bfloat16),
                                     0, group).wait()
            funcol.all_reduce(torch.zeros(32), "sum", group).wait()
            for _ in range(10):
                funcol.reduce_scatter_tensor(
                    torch.zeros(64, 8, dtype=torch.bfloat16), "sum", 0,
                    group).wait()
    finally:
        dist.destroy_process_group()
    got = cc.result()
    assert got["per_kind"] == want["per_kind"]
    assert got["total_bytes"] == want["total_bytes"]
    # the port's totals have no widened f32 to re-price; its count is of
    # collectives run (the loop's ten), the reference's of HLO ops
    assert got["total_bytes_norm"] == got["total_bytes"]
    assert got["n_ops"] == 12 and want["n_ops"] == 3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_cell_in_a_subprocess(tmp_path, mesh):
    _check_dryrun_cell(tmp_path, "olmo-1b", mesh)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "recurrentgemma-2b",
                                  "mamba2-780m"])
def test_dryrun_mixer_cell_in_a_subprocess(tmp_path, arch):
    """MLA, RG-LRU and SSD decode on the production mesh, their heads or
    channels over tp as the specs place them."""
    _check_dryrun_cell(tmp_path, arch, "16x16")


def test_param_count_under_a_fake_tensor_mode():
    """The cells size the moments from ``n_params`` while the dry run's
    fake mode is on; RG-LRU's init computes values only off ``meta``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = t_configs.get_config("recurrentgemma-2b")
    want = cfg.n_params()
    with FakeTensorMode(allow_non_fake_inputs=True):
        assert cfg.n_params() == want
        assert t_cells._moment_dtype(cfg) == torch.float32


def test_local_cost_counts_a_two_matmul_step():
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    m, k, n, p = 8, 16, 32, 4
    with fake:
        a, b, c = (torch.empty(m, k), torch.empty(k, n), torch.empty(n, p))
    cost = t_roof.LocalCost(fake, [a, b, c])
    with cost:
        ab = a @ b
        abc = ab @ c
        abc.mul_(2.0)
    f32 = 4
    assert cost.flops == 2 * m * k * n + 2 * m * n * p
    assert cost.bytes_accessed == f32 * ((m * k + k * n + m * n)
                                         + (m * n + n * p + m * p)
                                         + 2 * m * p)
    assert cost.peak == f32 * (m * k + k * n + n * p + m * n + m * p)


def _check_dryrun_cell(tmp_path, arch, mesh):
    """``arch`` x ``decode_32k`` on ``mesh`` in a subprocess: ``ok``, its
    argument bytes the sum of its inputs' local shards; its local FLOPs
    and bytes accessed counted; with a full KV cache (olmo), the donated
    cache counted once."""
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--shape", "decode_32k", "--out", str(out)]
        + (["--multi-pod"] if mesh != "16x16" else []),
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (cell,) = json.loads(out.read_text())
    sizes, names = MESHES[mesh]
    assert cell["ok"], cell.get("error")
    assert cell["mesh"] == mesh
    assert cell["chips"] == int(np.prod(sizes))

    # each input leaf's local shard: its bytes over the mesh axes that
    # shard it (the specs drop axes that do not divide)
    cfg = t_configs.get_config(arch)
    spec = t_configs.SHAPES["decode_32k"]
    mesh = MeshShape(names, sizes)
    rules = t_sh.make_rules(mesh)
    meta = Model(cfg, "meta")
    params, cache = meta.init(), meta.init_cache(spec.global_batch,
                                                 spec.seq_len)
    total = 0

    def add(specs, tree):
        nonlocal total

        def one(keys, t):
            nonlocal total
            s = specs
            for k in keys:
                s = s[k] if isinstance(s, dict) else s[int(k)]
            ways = 1
            for entry in t_sh.enforce_divisibility(s, t.shape, mesh):
                ways *= t_sh._axis_size(mesh, entry)
            total += t.numel() * t.element_size() // ways
        t_sh.tree_map_with_path(one, tree)

    add(t_sh.param_pspecs(params, rules), params)
    before = total
    add(t_sh.cache_pspecs(cache, cfg, rules), cache)
    cache_bytes = total - before
    dp = int(np.prod(sizes[:-1]))
    total += spec.global_batch * 4 // dp            # the token, over dp
    assert cell["memory"]["argument_size_in_bytes"] == total
    assert cell["memory"]["peak_memory_in_bytes"] >= total
    roof = cell["roofline"]
    assert roof["analytic_flops"] == t_roof.analytic_cost(cfg, spec)["flops"]
    assert roof["collective_bytes_per_device"] == cell["collective_bytes"] > 0
    assert isinstance(cell["flops"], float) and cell["flops"] > 0
    assert isinstance(cell["bytes_accessed"], float)
    assert cell["bytes_accessed"] > cell["memory"]["argument_size_in_bytes"]
    assert roof["xla_flops_per_device"] == cell["flops"]
    assert roof["xla_bytes_per_device"] == cell["bytes_accessed"]
    if arch == "olmo-1b":
        assert cell["memory"]["temp_size_in_bytes"] < cache_bytes
    assert set(cell["collective_ops"]) <= {"all-gather", "all-reduce",
                                           "reduce-scatter", "all-to-all"}
