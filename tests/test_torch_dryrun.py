"""The port's dry run (``launch/{dryrun,op_cost,roofline}``) against the
reference's ``launch/{dryrun,hlo_cost,roofline}``:

* (i) ``op_cost.analyze`` counts the flops ``hlo_cost.analyze`` reads
  from the compiled HLO of the same function (``tests/test_hlo_cost.py``'s
  cases: a matmul, a loop of n against a ``lax.scan`` of n, a nested
  loop, a batched dot, a gradient);
* (ii) ``collective_link_bytes`` equals ``parse_collectives`` on HLO lines
  of the same collectives, and ``roofline_terms`` / ``model_flops`` equal
  the reference's with the reference's constants;
* (iii) ``train_input_specs``, ``prefill_input_specs``, ``cache_spec``,
  ``param_count`` and ``active_param_count`` of every runnable cell;
* (iv) ``tests/test_dryrun_mini.py``'s nine cells at 8 fake ranks on a
  (2, 2, 2) CPU mesh with its assertions; a (1, 1) fake world against
  the mesh-less step counted by the same counter (flops equal; bytes
  equal op by op but for the ops ``MESH_OWN`` names); a (2, 2) fake
  world's flops a rank against the mesh-less step at half the batch,
  halved (each rank's share, not DTensor's global shapes);
* (vi) ``count_kernel_launches``: ``tests/test_torch_launch_counts.py``
  (no jax: its card case runs on the chip machine).

(The reference's own mini dry run fails here under jax 0.9 with
Explicit mesh axes, so the port is held to these parts and not to its
JSON.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, SHAPES, cell_runnable
from repro.configs import get_config as r_config
from repro.launch import hlo_cost
from repro.launch import roofline as RR
from repro.models import build_model as r_build
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as TR
from repro_torch.models.api import Model

DTYPES = {torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32,
          torch.float32: jnp.float32, torch.bool: jnp.bool_,
          torch.int8: jnp.int8}


def _hlo_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())[
        "flops"]


def _port_flops(fn, *shapes):
    gen = torch.Generator().manual_seed(0)
    return op_cost.analyze(fn, *[torch.randn(s, generator=gen)
                                 for s in shapes])["flops"]


# ------------------------------------------------------------ (i) op_cost

def test_plain_matmul_flops():
    shapes = ((64, 128), (128, 32))
    assert _port_flops(lambda x, y: x @ y, *shapes) == \
        _hlo_flops(lambda x, y: x @ y, *shapes) == 2 * 64 * 128 * 32


def test_loop_matmul_flops_count_every_trip():
    m, trips = 32, 7

    def scan(x, stack):
        return jax.lax.scan(lambda c, w: (c @ w, None), x, stack)[0]

    def loop(x, stack):
        for i in range(trips):
            x = x @ stack[i]
        return x
    shapes = ((m, m), (trips, m, m))
    assert _port_flops(loop, *shapes) == _hlo_flops(scan, *shapes) == \
        trips * 2 * m ** 3
    assert op_cost.analyze(loop, torch.ones(m, m), torch.ones(
        trips, m, m))["unknown_trip_whiles"] == 0


def test_nested_loops_multiply():
    m, outer, inner = 16, 3, 5

    def scan(x, stack):
        def obody(c, group):
            return jax.lax.scan(lambda ci, w: (ci @ w, None), c, group)[0], \
                None
        return jax.lax.scan(obody, x, stack)[0]

    def loop(x, stack):
        for i in range(outer):
            for j in range(inner):
                x = x @ stack[i, j]
        return x
    shapes = ((m, m), (outer, inner, m, m))
    assert _port_flops(loop, *shapes) == _hlo_flops(scan, *shapes) == \
        outer * inner * 2 * m ** 3


def test_batched_dot_flops():
    shapes = ((4, 8, 16), (4, 16, 8))
    assert _port_flops(lambda a, c: torch.einsum("bmk,bkn->bmn", a, c),
                       *shapes) == \
        _hlo_flops(lambda a, c: jnp.einsum("bmk,bkn->bmn", a, c),
                   *shapes) == 2 * 4 * 8 * 16 * 8


def test_gradient_is_about_three_forwards():
    """Autograd runs the forward product and the two gradient products;
    XLA drops the forward one, which the gradient of a sum does not
    read."""
    m = 32
    fwd = 2 * m ** 3
    x = torch.randn(m, m, requires_grad=True)
    w = torch.randn(m, m, requires_grad=True)
    port = op_cost.analyze(lambda a, b: torch.autograd.grad(
        (a @ b).sum(), (a, b)), x, w)["flops"]
    ref = _hlo_flops(lambda a, b: jax.grad(
        lambda u, v: jnp.sum(u @ v), argnums=(0, 1))(a, b), (m, m), (m, m))
    assert _port_flops(lambda a, b: (a @ b).sum(), (m, m), (m, m)) == fwd
    assert port == 3 * fwd and 2 * fwd <= ref <= port


# ----------------------------------------------------------- (ii) roofline

@pytest.mark.parametrize("records", [
    [("all-reduce", 4096, 4), ("all-gather", 1024, 16),
     ("reduce-scatter", 256, 2), ("all-to-all", 8192, 8),
     ("collective-permute", 512, 2), ("all-reduce", 100, 1)],
    [("all-gather", 12, 256), ("all-gather", 4, 2), ("all-reduce", 8, 16)],
])
def test_collective_link_bytes_equals_parse_collectives(records):
    lines = []
    for i, (op, nbytes, k) in enumerate(records):
        groups = "{{" + ",".join(map(str, range(k))) + "}}"
        lines.append(f"  %c{i} = f32[{nbytes // 4}]{{0}} {op}("
                     f"f32[{nbytes // 4}]{{0}} %p{i}), "
                     f"replica_groups={groups}")
    want = RR.parse_collectives("\n".join(lines))
    got = TR.collective_link_bytes(
        [{"op": op, "result_bytes": n, "group_size": k, "ranks": range(k)}
         for op, n, k in records])
    for op in RR._COLLECTIVES:
        assert {k: got[op][k] for k in want[op]} == want[op], op


def test_roofline_terms_and_model_flops_equal_the_references(monkeypatch):
    monkeypatch.setattr(TR, "PEAK_FLOPS", RR.PEAK_FLOPS)
    monkeypatch.setattr(TR, "HBM_BW", RR.HBM_BW)
    monkeypatch.setattr(TR, "NVLINK_BW", RR.ICI_BW)
    for args in ((1e12, 3e9, 4e8), (5e9, 1e12, 0.0), (1e10, 1e9, 9e10)):
        assert TR.roofline_terms(*args) == RR.roofline_terms(*args)
    for kind in ("train", "prefill", "decode"):
        assert TR.model_flops(1_234_567, 4096, kind) == \
            RR.model_flops(1_234_567, 4096, kind)


def test_group_links_follow_the_ranks_nodes():
    assert TR.link_bw(range(8)) == TR.NVLINK_BW
    assert TR.link_bw(range(8, 16)) == TR.NVLINK_BW
    assert TR.link_bw(range(16)) == TR.NET_BW      # (16, 16)'s "model"
    assert TR.link_bw(range(0, 256, 16)) == TR.NET_BW
    rec = TR.collective_link_bytes([{"op": "all-gather", "result_bytes": 16,
                                     "group_size": 16, "ranks": range(16)}])
    assert rec["all-gather"]["seconds"] == 15.0 / TR.NET_BW


# -------------------------------------------------------- (iii) input specs

CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES if cell_runnable(a, s)]


def _leaves(tree, width):
    """(name, per-layer shape, dtype) of a cache tree, each counted once
    per layer its leading stack axes hold."""
    out = []

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            for v in node:
                walk(v, key)
        else:
            nd = width[key]
            shape = tuple(node.shape)
            dtype = DTYPES.get(node.dtype, node.dtype)
            out.extend([(key, shape[-nd:], jnp.dtype(dtype))]
                       * int(np.prod(shape[:-nd], dtype=np.int64)))
    walk(tree, None)
    return sorted(out, key=str)


@pytest.mark.parametrize("arch, shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    ref = r_build(r_config(arch))
    port = Model(get_config(arch), torch.device("meta"))
    sh = SHAPES[shape]
    for name in ("train_input_specs", "prefill_input_specs"):
        want = {k: (tuple(v.shape), jnp.dtype(v.dtype))
                for k, v in getattr(ref, name)(sh).items()}
        got = {k: (tuple(v.shape), jnp.dtype(DTYPES[v.dtype]))
               for k, v in getattr(port, name)(sh).items()}
        assert got == want, name
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    if sh.kind == "decode":
        width = {"k": 4, "v": 4, "k_scale": 3, "v_scale": 3, "conv": 3,
                 "state": 4}
        b, s = sh.global_batch, sh.seq_len
        assert _leaves(port.cache_spec(b, s), width) == \
            _leaves(ref.cache_spec(b, s), width)


def test_abstract_params_have_the_references_shapes():
    for arch in ("qwen3-32b", "zamba2-1.2b", "paligemma-3b"):
        ref = jax.tree_util.tree_leaves_with_path(
            r_build(r_config(arch)).abstract_params())
        port = Model(get_config(arch), torch.device("meta")).abstract_params()
        for path, leaf in ref:
            node = port
            for key in path:
                node = node[key.key]
            assert node.device.type == "meta"
            assert (tuple(node.shape), jnp.dtype(DTYPES[node.dtype])) == \
                (tuple(leaf.shape), jnp.dtype(leaf.dtype))


# ------------------------------------------------- (iv) fake-world cells

MINI = ((2, 2, 2), ("pod", "data", "model"))


@pytest.mark.parametrize("arch,kind", [
    ("qwen3-32b", "train"),
    ("gemma3-1b", "train"),        # local/global groups + tail
    ("dbrx-132b", "train"),        # MoE expert-choice + EP sharding
    ("mamba2-370m", "train"),      # SSD scan
    ("zamba2-1.2b", "decode"),     # hybrid caches (ring + state)
    ("qwen3-32b", "decode"),
    ("gemma2-9b", "prefill"),
    ("hubert-xlarge", "prefill"),  # encoder forward
    ("paligemma-3b", "train"),     # vlm prefix-lm
])
def test_mini_dryrun_cell(arch, kind):
    res = D.run_cell(arch, None, "mini", mesh=MINI,
                     shape_cfg=ShapeCfg(f"mini_{kind}", 256, 8, kind),
                     smoke=True, device_type="cpu")
    assert res["n_devices"] == 8
    assert res["flops_per_device"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
    # a distributed step must actually communicate
    total_coll = sum(c["count"] for c in res["collectives"].values())
    assert total_coll > 0, res["collectives"]
    assert res["unknown_trip_whiles"] == 0
    assert not torch.distributed.is_initialized()


#: the ops whose bytes a (1, 1) mesh's step moves apart from the
#: mesh-less one's, by kind: the train loss's logsumexp over a vocabulary
#: that may be split (``base._VocabLSE``: amax, sub, exp, sum, log and add
#: where the mesh-less loss calls ``logsumexp``), the rope positions each
#: rank makes (``transformer._rope_local``: arange) and ``sq_norms``'
#: stack of the leaves' sums for its one all-reduce.  Any other op may
#: differ by a few scalars (the loss's count over the data axes).
MESH_OWN = {"train": {"logsumexp", "amax", "sub", "exp", "sum", "log",
                      "add", "arange", "stack"},
            "decode": set(), "prefill": {"arange"}}
SCALARS = 64


@pytest.mark.parametrize("arch,kind", [("qwen3-32b", "train"),
                                       ("gemma3-1b", "decode"),
                                       ("zamba2-1.2b", "prefill")])
def test_one_rank_world_counts_the_meshless_step(arch, kind):
    shape = ShapeCfg(f"mini_{kind}", 128, 4, kind)
    res = D.run_cell(arch, None, "mini", mesh=((1, 1), ("data", "model")),
                     shape_cfg=shape, smoke=True, device_type="cpu")
    plain = D.trace(get_config(arch, smoke=True), shape, None,
                    torch.device("cpu"))
    assert res["flops_per_device"] == plain["flops"]
    got, want = res["raw_cost_analysis"]["bytes_by_op"], plain["bytes_by_op"]
    apart = {op: got.get(op, 0) - want.get(op, 0)
             for op in set(got) | set(want)
             if got.get(op, 0) != want.get(op, 0)}
    assert {op for op, d in apart.items() if abs(d) > SCALARS} \
        <= MESH_OWN[kind], apart
    if kind == "decode":
        assert not apart and res["bytes_per_device"] == plain["bytes"]
    assert sum(c["count"] for c in res["collectives"].values()) == 0


@pytest.mark.parametrize("arch,kind", [("qwen3-32b", "train"),
                                       ("gemma3-1b", "train"),
                                       ("qwen3-32b", "prefill"),
                                       ("qwen3-32b", "decode"),   # KV split
                                       ("gemma3-1b", "decode")])  # hd split
def test_split_world_counts_one_ranks_share(arch, kind):
    """On (2, 2) a dense step splits its batch over "data" and every
    matrix product over "model" (heads, kv heads or head_dim, MLP
    columns, vocabulary): one rank's flops are the mesh-less step's at
    half the batch, halved.  A count of DTensor's global shapes would
    be 4x that (about 2x at decode, whose 64-row calls pad the batch),
    one divided twice less."""
    res = D.run_cell(arch, None, "mini", mesh=((2, 2), ("data", "model")),
                     shape_cfg=ShapeCfg(f"mini_{kind}", 128, 8, kind),
                     smoke=True, device_type="cpu")
    half = D.trace(get_config(arch, smoke=True),
                   ShapeCfg(f"mini_{kind}", 128, 4, kind), None,
                   torch.device("cpu"))
    assert res["n_devices"] == 4
    assert res["flops_per_device"] == half["flops"] / 2
    assert sum(c["count"] for c in res["collectives"].values()) > 0


def test_list_and_cli_keep_the_references_flags(capsys):
    D.main(["--list"])
    cells = capsys.readouterr().out.split("\n")
    assert "zamba2-1.2b long_500k" in cells
    assert "qwen3-32b long_500k" not in cells
    assert len([c for c in cells if c]) == len(CELLS)
