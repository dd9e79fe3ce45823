"""The port's sharding rules against the reference's, with no world: the
logical-axis resolution (``models.base``), every parameter's spec
(``models.api.param_specs`` against ``spec_tree`` through
``param_layout``) for all ten configs at full width, and the runtime
specs of ``launch.sharding``, each on the same stand-in meshes.  Both
packages' helpers read only a mesh's axis names and sizes, so a
``SimpleNamespace(axis_names=..., shape={...})`` serves both.  Then
``placements`` and ``distribute`` on a real one-rank CPU mesh, made in
this module and destroyed after it.
"""
import datetime
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import configs as RCFG
from repro.launch import sharding as RS
from repro.models import base as RB
from repro.models import build_model as r_build
from repro_torch import configs as TCFG
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as TS
from repro_torch.models import api as TAPI
from repro_torch.models import base as TB
from repro_torch.models import transformer as TT


def stand_in(shape, names):
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, shape)))


MESHES = {
    "16x16": stand_in((16, 16), ("data", "model")),
    "2x16x16": stand_in((2, 16, 16), ("pod", "data", "model")),
    "2x2": stand_in((2, 2), ("data", "model")),
}
ARCHS = RCFG.ARCH_NAMES


def same(port_spec, ref_spec):
    return tuple(port_spec) == tuple(ref_spec)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("logical, shape", [
    (("batch", None, "model"), (32, 7, 64)),
    (("batch", None, "model"), (3, 7, 5)),           # nothing divides
    (("fsdp", "model"), (4096, 1024)),
    (("model", "fsdp"), (262144, 1152)),
    (("layers", "fsdp", "model"), (26, 1152, 256)),
    (("seq", "seq_data", None), (8, 64, 3)),
    ((None, "unknown"), (16, 16)),
])
def test_resolve_logical_matches_reference(mesh, logical, shape):
    m = MESHES[mesh]
    assert same(TB.resolve_logical(logical, shape, m),
                RB.resolve_logical(logical, shape, m))
    assert TB.mesh_axes(m) == RB.mesh_axes(m)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_spec_tree(arch, mesh):
    """Each parameter's spec is its stacked leaf's ``spec_tree`` entry
    less the stack axes (full width: the divisibility fallbacks are
    the production ones)."""
    m = MESHES[mesh]
    rcfg = RCFG.get_config(arch)
    tree = RB.spec_tree(r_build(rcfg).template(), m)
    specs = TAPI.param_specs(TCFG.get_config(arch), m)
    layout = TAPI.param_layout(TCFG.get_config(arch))
    assert list(specs) == [name for name, _, _, _ in layout]
    for name, path, idx, p in layout:
        want = tree
        for key in path:
            want = want[key]
        want = tuple(want)
        lead = len(want) - len(p.shape)
        assert lead == len(idx) and want[:lead] == (None,) * lead, name
        assert same(specs[name], want[lead:]), (name, specs[name], want)


def test_spec_tree_matches_reference_on_a_template():
    m = MESHES["2x16x16"]
    rcfg = RCFG.get_config("dbrx-132b")
    want = jax.tree_util.tree_leaves(
        RB.spec_tree(r_build(rcfg).template(), m),
        is_leaf=lambda x: isinstance(x, JP))
    got = []

    def walk(node):
        if isinstance(node, TB.P):
            got.append(node)
        else:
            for k in sorted(node):
                walk(node[k])
    walk(TB.spec_tree(TAPI.template(TCFG.get_config("dbrx-132b")), m))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("ndim, rows", [(2, 256), (3, 4), (1, 512), (2, 1),
                                        (2, 48)])
def test_batch_spec_matches_reference(mesh, ndim, rows):
    m = MESHES[mesh]
    assert same(TS.batch_spec(m, ndim, rows), RS.batch_spec(m, ndim, rows))
    assert TM.data_axes(m) == tuple(a for a in ("pod", "data")
                                    if a in m.axis_names)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("axis, ndim, rows", [
    ("data", 2, 1024), ("model", 3, 64), ("data", 2, 6), ("pod", 2, 4),
    ("replica", 2, 8)])
def test_bank_batch_spec_matches_reference(mesh, axis, ndim, rows):
    m = MESHES[mesh]
    try:
        want = RS.bank_batch_spec(m, axis, ndim, rows)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TS.bank_batch_spec(m, axis, ndim, rows)
        assert str(got.value) == str(e)
        return
    assert same(TS.bank_batch_spec(m, axis, ndim, rows), want)


CACHE_SHAPES = [
    (128, 32768, 8, 128),          # batch and kv heads divide
    (1, 32768, 8, 128),            # B = 1: the sequence on "data"
    (1, 500, 1, 256),              # nothing but head_dim divides
    (64, 4096, 1, 256),            # kv = 1: head_dim on "model"
    (4, 2, 7, 64, 16, 80),         # stacked prefix axes
    (3, 5, 3, 3),                  # nothing divides
]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", CACHE_SHAPES)
def test_attn_cache_spec_matches_reference(mesh, shape):
    m = MESHES[mesh]
    assert same(TS.attn_cache_spec(m, shape), RS.attn_cache_spec(m, shape))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", [(64, 3, 4352), (1, 3, 4352),
                                   (2, 64, 3, 2176), (5, 3, 7)])
def test_ssm_conv_spec_matches_reference(mesh, shape):
    m = MESHES[mesh]
    assert same(TS.ssm_conv_spec(m, shape), RS.ssm_conv_spec(m, shape))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", [(64, 64, 64, 64), (1, 32, 128, 64),
                                   (6, 2, 8, 64, 64), (3, 3, 4, 4)])
def test_ssm_state_spec_matches_reference(mesh, shape):
    m = MESHES[mesh]
    assert same(TS.ssm_state_spec(m, shape), RS.ssm_state_spec(m, shape))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch, kv_dtype", [
    ("gemma3-1b", "bf16"), ("gemma2-9b", "int8"), ("zamba2-1.2b", "bf16"),
    ("mamba2-370m", "bf16"), ("qwen3-32b", "int8")])
def test_cache_specs_match_reference(mesh, arch, kv_dtype):
    """The port's caches (one dict a layer) against the reference's
    ``cache_specs`` on the same leaves."""
    m = MESHES[mesh]
    cfg = TCFG.get_config(arch, kv_cache_dtype=kv_dtype)
    model = TAPI.Model(cfg, torch.device("meta"))
    layers = model.cache_spec(32, 4096)
    got = TS.cache_specs({"layers": layers}, m)
    ref_tree = {"layers": [{k: jax.ShapeDtypeStruct(s.shape, np.float32)
                            for k, s in layer.items()} for layer in layers]}
    want = RS.cache_specs(ref_tree, m)
    assert len(got["layers"]) == len(want["layers"]) > 0
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for k in g:
            assert same(g[k], w[k]), (k, g[k], w[k])


def test_cache_specs_refuse_unknown_leaves():
    with pytest.raises(ValueError, match="unknown cache leaf"):
        TS.cache_specs({"x": torch.empty(2, 2)}, MESHES["2x2"])


def test_attention_layout_follows_the_heads():
    """q on its heads where they divide and every rank's heads read
    whole kv heads; else replicated over the model axis."""
    m = MESHES["2x2"]
    dense = TCFG.get_config("qwen3-32b")          # 64 q, 8 kv heads
    assert TT.attention_layout(dense, m) == (Shard(2), Shard(2), None)
    gemma3 = TCFG.get_config("gemma3-1b")         # 4 q, 1 kv head
    assert TT.attention_layout(gemma3, m) == (Shard(2), Replicate(), 1)
    assert TT.attention_layout(gemma3, MESHES["16x16"]) == (
        Replicate(), Replicate(), None)
    seq = TCFG.get_config("gemma3-1b", attn_fallback="seq")
    assert TT.use_context_parallel(seq, MESHES["16x16"], 4096)
    assert not TT.use_context_parallel(seq, m, 4096)      # heads divide
    assert not TT.use_context_parallel(gemma3, MESHES["16x16"], 4096)


def test_meshes_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        TM.make_host_mesh(1, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        TM.make_production_mesh(device_type="cpu")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo world for this module, destroyed after it (a
    process group left behind would change what later modules of the
    same worker see)."""
    assert not dist.is_initialized()
    store = tmp_path_factory.mktemp("one_rank") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield TM.make_host_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


def test_placements_on_a_one_rank_mesh(one_rank):
    mesh = one_rank
    assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (1, 1)
    assert TB.placements(TB.P("data", "model"), mesh) == (Shard(0), Shard(1))
    assert TB.placements(TB.P("model", None, "data"), mesh) == (
        Shard(2), Shard(0))
    assert TB.placements(TB.P(("data", "model"), None), mesh) == (
        Shard(0), Shard(0))
    assert TB.placements(TB.P(None, None), mesh) == (Replicate(),
                                                     Replicate())
    t = torch.arange(24.0).reshape(4, 6)
    d = TB.distribute(t, mesh, TB.placements(TB.P("data", "model"), mesh))
    assert isinstance(d, DTensor) and torch.equal(d.full_tensor(), t)
    assert torch.equal(d.to_local(), t)
    tree = TB.shard_tree({"a": t, "b": {"c": t[0]}},
                         {"a": TB.P("data", None), "b": {"c": TB.P()}}, mesh)
    assert tree["a"].placements == (Shard(0), Replicate())
    assert tree["b"]["c"].placements == (Replicate(), Replicate())
    specs = {"tokens": torch.empty(8, 16), "pos": torch.empty(8)}
    assert TS.batch_shardings(specs, mesh) == {
        "tokens": (Shard(0), Replicate()), "pos": (Shard(0), Replicate())}
    assert TS.named(mesh, {"k": TB.P(None, "model")}) == {
        "k": (Replicate(), Shard(1))}
    with pytest.raises(ValueError, match="does not divide"):
        TM.make_host_mesh(2, "cpu")
    with pytest.raises(ValueError, match="holds 256 ranks"):
        TM.make_production_mesh(device_type="cpu")


def test_distribute_keeps_the_seeded_init(one_rank):
    """A distributed model's parameters are its mesh-less init's bits,
    at ``param_specs``' placements."""
    mesh = one_rank
    cfg = TCFG.get_config("gemma3-1b", smoke=True)
    plain = TAPI.build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(3))
    dist_model = TAPI.build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(3)).distribute_(mesh)
    specs = dist_model.param_specs(mesh)
    for (name, p), (_, q) in zip(dist_model.named_parameters(),
                                 plain.named_parameters()):
        assert isinstance(p, DTensor) and p.placements == \
            TB.placements(specs[name], mesh), name
        assert torch.equal(p.full_tensor().view(torch.int16)
                           if p.dtype == torch.bfloat16 else p.full_tensor(),
                           q.view(torch.int16) if q.dtype == torch.bfloat16
                           else q), name
