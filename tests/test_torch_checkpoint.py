"""The port's checkpoint manager (``repro_torch.checkpoint``): round
trips, retention, CRC checks, async saves, and the on-disk layout shared
with the JAX package's -- each restores the other's checkpoints bit for
bit, and the same content gives the same manifest and the same files.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.checkpoint import CheckpointManager as RefManager
from repro.models import build_model as r_build
from repro.optim import adamw as RADAM
from repro_torch import configs as TCFG
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import api as TAPI
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import init_state
from repro_torch.runtime import trainer as TR

from test_torch_models import as_numpy, ref_params

ARCH = "zamba2-1.2b"        # stacked groups, a tail, one shared block,
#                             bf16 and float32 leaves


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs one
    module a worker and several workers a machine, where eight threads a
    worker oversubscribe the cores and this module's small ops spin
    more than they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn((3, 5), generator=gen).to(torch.bfloat16),
            "sub": {"b": torch.randn((4,), generator=gen),
                    "n": torch.tensor(7, dtype=torch.int32)},
            "a": torch.arange(6, dtype=torch.int64).reshape(2, 3)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_round_trip_keeps_dtypes_and_bits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    path = mgr.save(3, tree)
    assert os.path.basename(path) == "step_000000003"
    assert mgr.latest_step() == 3
    assert _equal_trees(mgr.restore(3, tree), tree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 3
    assert [(a["name"], a["file"], a["dtype"], a["shape"])
            for a in manifest["arrays"]] == [
        ("a", "arr_000000.npy", "int64", [2, 3]),
        ("sub/b", "arr_000001.npy", "float32", [4]),
        ("sub/n", "arr_000002.npy", "int32", []),
        ("w", "arr_000003.npy", "bfloat16", [3, 5])]
    assert np.load(os.path.join(path, "arr_000003.npy")).dtype == np.uint16


def test_retention_keeps_the_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 5, 9):
        mgr.save(step, _tree())
    assert mgr.all_steps() == [5, 9]
    os.makedirs(tmp_path / "step_000000011.tmp")   # a crashed write
    assert mgr.latest_step() == 9


def test_crc_corruption_is_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, _tree())
    f = os.path.join(path, "arr_000001.npy")
    arr = np.load(f)
    arr[0] += 1.0
    np.save(f, arr)
    with pytest.raises(IOError, match="CRC mismatch for sub/b"):
        mgr.restore(1, _tree())


def test_restore_checks_names_and_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    like = _tree()
    like["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="missing arrays"):
        mgr.restore(1, like)
    like = _tree()
    like["w"] = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, like)


def test_save_async_copies_now_and_writes_later(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = {"w": tree["w"].clone(), "sub": dict(tree["sub"]),
            "a": tree["a"].clone()}
    mgr.save_async(4, tree)
    tree["w"].zero_()                  # the host copy was taken already
    mgr.wait()
    assert mgr.latest_step() == 4
    assert _equal_trees(mgr.restore(4, want), want)
    mgr.save_async(5, want)
    mgr.save_async(6, want)            # joins the previous save first
    mgr.wait()
    assert mgr.all_steps() == [4, 5, 6]


def test_save_async_without_copy_writes_the_leaves_handed_over(tmp_path):
    """``copy=False`` (the trainer's fresh ``state_tree``) saves host
    leaves without a second host copy, and writes the same checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    host = dict((name, saved) for name, saved, _ in mgr._host(tree, False))
    assert np.shares_memory(host["sub/b"], tree["sub"]["b"].numpy())
    assert np.shares_memory(host["w"], tree["w"].view(torch.int16).numpy())
    mgr.save_async(1, tree, copy=False)
    mgr.wait()
    mgr.save(2, tree)
    assert _equal_trees(mgr.restore(1, tree), tree)
    files = [sorted(os.listdir(tmp_path / f"step_{s:09d}")) for s in (1, 2)]
    assert files[0] == files[1]
    for name in files[0]:
        a = (tmp_path / f"step_{1:09d}" / name).read_bytes()
        b = (tmp_path / f"step_{2:09d}" / name).read_bytes()
        assert a.replace(b'"step": 1', b'"step": 2') == b


# ------------------------------------------------------ across packages

def _ref_state(rcfg, seed=1):
    """A reference ``{"params", "opt"}`` tree with nonzero moments."""
    params = ref_params(rcfg)
    rng = np.random.default_rng(seed)
    moments = [jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        params) for _ in range(2)]
    return {"params": params, "opt": {"step": jnp.asarray(12, jnp.int32),
                                      "m": moments[0], "v": moments[1]}}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rcfg = RCFG.get_config(ARCH, smoke=True)
    tcfg = TCFG.get_config(ARCH, smoke=True)
    ref = _ref_state(rcfg)
    RefManager(str(tmp_path)).save(12, ref)
    model = build_model(tcfg, "cpu")
    opt = init_state(dict(model.named_parameters()))
    mgr = CheckpointManager(str(tmp_path))
    TR.load_state(model, opt, mgr.restore(12, TR._like_tree(tcfg)))
    want = params_from_numpy(tcfg, as_numpy(ref["params"], bits=True),
                             "cpu")
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(_bits(got[k]).equal(_bits(want[k])) for k in want)
    assert int(opt["step"]) == 12 and opt["step"].dtype == torch.int32
    for key in ("m", "v"):
        for name, path, idx, _ in TAPI.param_layout(tcfg):
            leaf = ref["opt"][key]
            for k in path:
                leaf = leaf[k]
            np.testing.assert_array_equal(
                opt[key][name].numpy(),
                np.asarray(leaf[idx] if idx else leaf))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rcfg = RCFG.get_config(ARCH, smoke=True)
    tcfg = TCFG.get_config(ARCH, smoke=True)
    model = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(3))
    opt = init_state(dict(model.named_parameters()))
    gen = torch.Generator().manual_seed(4)
    for key in ("m", "v"):
        for t in opt[key].values():
            t.copy_(torch.randn(t.shape, generator=gen))
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    CheckpointManager(str(tmp_path)).save(7, TR.state_tree(model, opt))

    rmodel = r_build(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    like = {"params": params, "opt": RADAM.init_state(params)}
    got = RefManager(str(tmp_path)).restore(7, like)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(like)
    want = TAPI.params_to_numpy(tcfg, model.state_dict())
    for (path, leaf), template in zip(
            jax.tree_util.tree_flatten_with_path(got["params"])[0],
            jax.tree_util.tree_leaves(like["params"])):
        w = want
        for k in path:
            w = w[k.key]
        assert leaf.dtype == template.dtype, path
        a = np.asarray(leaf)
        np.testing.assert_array_equal(
            a.view(np.uint16) if a.dtype == jnp.bfloat16 else a, w)
    assert int(got["opt"]["step"]) == 7
    for key in ("m", "v"):
        want_m = TAPI.stack_tree(tcfg, opt[key])
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                got["opt"][key])[0]:
            w = want_m
            for k in path:
                w = w[k.key]
            np.testing.assert_array_equal(np.asarray(leaf), w.numpy())


def test_same_content_same_files(tmp_path):
    """The two managers write the same manifest and byte-identical
    ``.npy`` files for one model state."""
    rcfg = RCFG.get_config(ARCH, smoke=True)
    tcfg = TCFG.get_config(ARCH, smoke=True)
    ref = _ref_state(rcfg)
    a = RefManager(str(tmp_path / "ref")).save(12, ref)
    model = build_model(tcfg, "cpu")
    model.load_state_dict(params_from_numpy(
        tcfg, as_numpy(ref["params"], bits=True), "cpu"))
    opt = {"step": torch.tensor(12, dtype=torch.int32)}
    for key in ("m", "v"):
        opt[key] = {k: torch.tensor(v) for k, v in TAPI.unstack_tree(
            tcfg, as_numpy(ref["opt"][key])).items()}
    b = CheckpointManager(str(tmp_path / "port")).save(
        12, TR.state_tree(model, opt))
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b))
    for f in files:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_stack_tree_inverts_unstack_tree():
    tcfg = TCFG.get_config("gemma3-1b", smoke=True)
    model = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    tree = TAPI.stack_tree(tcfg, sd)
    assert tree["groups"]["local"]["attn"]["wq"].shape == (1, 5, 128, 128)
    back = TAPI.unstack_tree(tcfg, tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(_bits(back[k]), _bits(sd[k])) for k in sd)
    again = params_from_numpy(tcfg, TAPI.params_to_numpy(tcfg, sd), "cpu")
    assert all(torch.equal(_bits(again[k]), _bits(sd[k])) for k in sd)
