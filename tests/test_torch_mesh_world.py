"""The port's mesh path in 4-rank ``gloo`` worlds on the CPU, held to the
mesh-less port and to the reference.  Three worlds, each spawned once
for the module by its own fixture and under its own time limit (each
rank writes its results, the tests below read them), so one world's
failure errors only its own tests:

* the training world: ``make_train_step(mesh=...)`` on a (2, 2)
  ("data", "model") mesh for the smoke configs of qwen3-32b (dense),
  gemma3-1b (local/global, one kv head), dbrx-132b and llama4-scout
  with ``moe_local_dispatch`` (MoE; the mesh-less run takes the same
  shard-local routing with 2 groups), llama4-scout's global expert
  choice and token choice, zamba2-1.2b (hybrid SSM), and gemma3-1b with
  3 query heads under the "seq" (context-parallel) and "hd" fallbacks:
  the placements are ``param_specs``', the first step's loss and every
  gradient leaf match the mesh-less port in float32 (loss 1e-5,
  gradients 1e-4 relative L2), the bf16 loss within 1e-3, three bf16
  steps' losses match within 1e-3 and are the same bits on every rank,
  and ``exact_accum`` over 2 microbatches gives the bits of the
  mesh-less ``exact_tree_sum`` of the same microbatch gradients;
* the layout world: a (2, 2, 1) ("pod", "data", "model") mesh splits a
  batch over both data axes in the reference's row order and trains to
  the mesh-less loss; ``flash_attention_context_parallel`` on a (1, 4)
  mesh with the reference test's cases: each rank's slice against the
  reference's ``flash_attention`` of that slice with its offsets, the
  whole within 0.05 of the reference's full attention; a checkpoint
  written from a mesh-less model restores onto the (2, 2) mesh at the
  asked placements with equal values;
* the launch world: ``launch.train --model-parallel 2`` against the same
  run mesh-less, and under ``torch.distributed.run`` (the launcher's
  variables).

No rank waits at a collective on another rank's private work: the
mesh-less references run in a world-free process (``PLAIN``), the
reference's attention in another (``CP_REFERENCE``), and the checkpoint
is written by the test process before its world starts.  A rank's gloo
timeout is its own time limit.

``_expert_choice_local`` is also held to the reference's in one process.
"""
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RM
from repro_torch.launch import train as LT
from repro_torch.models import moe as TMOE

from test_torch_moe import activations, layer, router_logits
from test_torch_models import rel_err

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
LIMIT_S = 600
#: case -> (config, overrides, (batch, sequence)): the four families;
#: llama4-scout's global expert choice, and its token choice (a batch of
#: at most 4 tokens an expert); gemma3-1b with 3 query heads, which a
#: 2-rank model axis does not divide: the "seq" fallback
#: (context-parallel attention inside the model) and "hd"
CASES = {
    "qwen3-32b": ("qwen3-32b", {}, (4, 128)),
    "gemma3-1b": ("gemma3-1b", {}, (4, 128)),
    "dbrx-132b": ("dbrx-132b", {"moe_local_dispatch": True}, (4, 128)),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e",
                              {"moe_local_dispatch": True}, (4, 128)),
    "llama4-global": ("llama4-scout-17b-a16e", {}, (4, 128)),
    "llama4-token-choice": ("llama4-scout-17b-a16e", {}, (4, 4)),
    "zamba2-1.2b": ("zamba2-1.2b", {}, (4, 128)),
    "gemma3-1b-3heads-seq": ("gemma3-1b", {"n_heads": 3,
                                           "attn_fallback": "seq"},
                             (4, 128)),
    "gemma3-1b-3heads-hd": ("gemma3-1b", {"n_heads": 3,
                                          "attn_fallback": "hd"}, (4, 128)),
}
ARCHS = tuple(CASES)
LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-3}
F32_GRAD_RTOL = 1e-4
CP_CASES = [("causal", None), ("local", 128), ("prefix", None),
            ("none", None)]
CP = dict(B=2, S=512, H=4, KV=1, D=64, chunk=128)
TRAIN_ARGS = ["--arch", "qwen3-32b", "--smoke", "--steps", "6", "--seq-len",
              "64", "--global-batch", "4", "--source", "pattern",
              "--device", "cpu", "--no-resume", "--checkpoint-every", "3"]

#: what every script below shares: its arguments, the saved inputs and
#: the helpers; a rank script then joins its world (its gloo timeout the
#: rank's own limit), a world-free script does not
PRELUDE = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.models import build_model, moe
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.optim.adamw import placed_like

rank, world, inp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfgs, out = json.loads(sys.argv[4]), sys.argv[5]
torch.set_num_threads(1)
data = dict(np.load(inp))
res = {}
lead = rank == 0
saved_expert_choice = moe._expert_choice_local


def bits(t):
    t = t.detach()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.view(torch.int32).numpy()


def local_routing(cfg):
    # the mesh-less run takes the mesh's shard-local routing (2 groups)
    if cfg.moe_local_dispatch:
        moe._expert_choice_local = \
            lambda p, xn, lg, cfg, groups, train=False: \
            saved_expert_choice(p, xn, lg, cfg, 2, train)


def batch_of(arch):
    return {k: torch.from_numpy(data[f"{arch}/{k}"])
            for k in ("tokens", "labels", "mask")}


def step_batch(arch, i):
    return {k: torch.from_numpy(data[f"{arch}/steps/{k}"][i])
            for k in ("tokens", "labels", "mask")}


def loss_grads(model, batch, mesh, grads=True):
    if not grads:
        with torch.no_grad():
            return float(model.train_loss(batch, mesh)), {}
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss = model.train_loss(batch, mesh)
    grads = torch.autograd.grad(loss, list(named.values()))
    if mesh is not None:
        grads = [g.full_tensor() for g in placed_like(
            named, dict(zip(named, grads))).values()]
    return float(loss.detach()), dict(zip(named, grads))


def join():
    dist.init_process_group(
        "gloo", init_method="file://" + cfgs["store"], rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=cfgs["limit"]))


def gathered_losses(v):
    got = [None] * world
    dist.all_gather_object(got, v)
    return got


def leave():
    dist.barrier()
    dist.destroy_process_group()
"""

#: the mesh-less references of the training cases, in one process with no
#: process group: the first step's loss (and float32 gradients) and three
#: bf16 steps' losses, under the mesh's shard-local routing
PLAIN = PRELUDE + r"""
from repro_torch.runtime import make_train_step

opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
for arch, (name, over, _) in cfgs["cases"].items():
    cfg = get_config(name, smoke=True, **over)
    local_routing(cfg)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        plain = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        if dtype == torch.float32:
            plain.float()
        pl, pg = loss_grads(plain, batch_of(arch), None,
                            dtype == torch.float32)
        res[f"{arch}/{tag}/loss"] = pl
        for n in pg:
            res[f"{arch}/{tag}/grad/{n}"] = pg[n].numpy()
    plain = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    pstep = make_train_step(plain, opt)
    pstate = init_state(dict(plain.named_parameters()))
    res[f"{arch}/plain_losses"] = [pstep(pstate, step_batch(arch, i))["loss"]
                                   for i in range(3)]
    moe._expert_choice_local = saved_expert_choice
np.save(out, np.array(res, dtype=object), allow_pickle=True)
"""

#: the training cases on a (2, 2) mesh: placements, the first step's loss
#: and gradients, three bf16 steps, exact accumulation
TRAIN_WORLD = PRELUDE + r"""
from repro_torch.data import device_batch
from repro_torch.exact import exact_tree_sum
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.base import placements
from repro_torch.runtime import make_train_step
from repro_torch.runtime import trainer as TR

join()
mesh = make_host_mesh(2, "cpu")
for arch, (name, over, _) in cfgs["cases"].items():
    cfg = get_config(name, smoke=True, **over)
    batch = batch_of(arch)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        meshed = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        if dtype == torch.float32:
            meshed.float()
        meshed.distribute_(mesh)
        specs = meshed.param_specs(mesh)
        res[f"{arch}/placed"] = all(
            p.placements == placements(specs[n], mesh)
            for n, p in meshed.named_parameters())
        ml, mg = loss_grads(meshed, device_batch(batch, mesh=mesh), mesh,
                            dtype == torch.float32)
        if lead:
            res[f"{arch}/{tag}/loss"] = ml
            for n in mg:
                res[f"{arch}/{tag}/grad/{n}"] = mg[n].numpy()
    # three bf16 steps, then exact accumulation over 2 microbatches
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    meshed = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step = make_train_step(meshed, opt, mesh=mesh)
    state = init_state(dict(meshed.named_parameters()))
    res[f"{arch}/moments_placed"] = all(
        state[k][n].placements == p.placements
        for n, p in meshed.named_parameters() for k in ("m", "v"))
    losses = [step(state, device_batch(step_batch(arch, i), mesh=mesh))[
        "loss"] for i in range(3)]
    res[f"{arch}/ranks_losses"] = gathered_losses(losses)
    if arch == "qwen3-32b":
        # a state dict (params_from_numpy's) into a distributed model
        source = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(3))
        loaded = build_model(cfg, "cpu").distribute_(mesh)
        loaded.load_state_dict(source.state_dict())
        res["load_state_dict"] = all(
            np.array_equal(bits(p.full_tensor()), bits(q))
            for p, q in zip(loaded.parameters(), source.parameters()))
        halves = [device_batch({k: v[i * 2:(i + 1) * 2] for k, v in
                                batch.items()}, mesh=mesh) for i in (0, 1)]
        named = dict(meshed.named_parameters())
        gs = []
        for half in halves:
            grads = torch.autograd.grad(meshed.train_loss(half, mesh),
                                        list(named.values()))
            gs.append(list(placed_like(named, dict(zip(named,
                                                       grads))).values()))
        acc = [g.full_tensor() for g in TR._accumulate(gs, True, mesh)]
        want = exact_tree_sum([[g.full_tensor() for g in row] for row in gs])
        want = [TR._div(w, 2) for w in want]
        res["exact_accum_equal"] = all(np.array_equal(bits(a), bits(w))
                                       for a, w in zip(acc, want))
        ex = make_train_step(meshed, opt, mesh=mesh, microbatches=2,
                             exact_accum=True)
        res["exact_step_loss"] = ex(state, device_batch(batch, mesh=mesh))[
            "loss"]
leave()
np.save(out, np.array(res, dtype=object), allow_pickle=True)
"""

#: the (2, 2, 1) pod mesh, context parallel on (1, 4), and the restore of
#: a mesh-less checkpoint (written by the test process) onto (2, 2)
LAYOUT_WORLD = PRELUDE + r"""
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import device_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.models.attention import flash_attention_context_parallel
from repro_torch.models.base import distribute, local_chunk, placements
from repro_torch.runtime import trainer as TR

join()
# (2, 2, 1) ("pod", "data", "model"): the batch over both data axes
pod = init_device_mesh("cpu", (2, 2, 1),
                       mesh_dim_names=("pod", "data", "model"))
cfg = get_config("qwen3-32b", smoke=True)
placed = device_batch(batch_of("qwen3-32b"), mesh=pod)
res["pod/rows"] = placed["tokens"].to_local().numpy()
model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
model.float().distribute_(pod)
res["pod/loss"] = loss_grads(model, placed, pod, False)[0]

# context-parallel attention on a (1, 4) mesh
cp = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
q, k, v = (torch.from_numpy(data["cp/" + n]).to(torch.bfloat16)
           for n in "qkv")
whole = placements((None,) * 4, cp)
for kind, window, prefix in cfgs["cp"]:
    o = flash_attention_context_parallel(
        distribute(q, cp, whole), distribute(k, cp, whole),
        distribute(v, cp, whole), cp, mask_kind=kind, window=window,
        prefix_len=prefix, q_chunk=cfgs["chunk"], k_chunk=cfgs["chunk"])
    res[f"cp/{kind}/local"] = o.to_local().float().numpy()
    full = o.full_tensor()
    if lead:
        res[f"cp/{kind}/full"] = full.float().numpy()

# the mesh-less checkpoint restored onto the (2, 2) mesh
mesh = make_host_mesh(2, "cpu")
model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(7))
tree = TR.state_tree(model, init_state(dict(model.named_parameters())))
specs = api.param_specs(cfg, mesh)
where = {"params": {}, "opt": {"step": None, "m": {}, "v": {}}}
for path, (shape, members) in api.stacked_layout(cfg).items():
    spec = (None,) * (len(shape) - len(specs[members[0][0]])) \
        + tuple(specs[members[0][0]])
    for root in (where["params"], where["opt"]["m"], where["opt"]["v"]):
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (mesh, placements(spec, mesh))
back = CheckpointManager(cfgs["ckpt"]).restore(5, tree, placements=where)
ok, n_sharded = True, 0
for path in api.stacked_layout(cfg):
    node, want = back["params"], tree["params"]
    for key in path:
        node, want = node[key], want[key]
    spec = where["params"]
    for key in path:
        spec = spec[key]
    ok &= isinstance(node, DTensor) and node.placements == spec[1]
    ok &= torch.equal(node.to_local(), local_chunk(want, mesh, spec[1]))
    n_sharded += any(p.is_shard() for p in spec[1])
res["reshard_ok"] = bool(ok)
res["reshard_sharded"] = n_sharded
leave()
np.save(out, np.array(res, dtype=object), allow_pickle=True)
"""

#: launch.train --model-parallel 2 on a world the script made
LAUNCH_WORLD = PRELUDE + r"""
from repro_torch.launch import train as LT

join()
tres = LT.main(cfgs["train_args"] + ["--model-parallel", "2",
                                     "--checkpoint-dir", cfgs["train_dir"]])
res["train/losses"] = gathered_losses(tres.losses)
res["train/final_step"] = tres.final_step
leave()
np.save(out, np.array(res, dtype=object), allow_pickle=True)
"""

#: the reference's context-parallel attention, in a process of its own
#: (jax stays out of the test process): each rank's slice by its own
#: per-shard call (the shard_map body), and the whole
CP_REFERENCE = r"""
import json, sys
import jax.numpy as jnp
import numpy as np
from repro.models import attention as RA

inp, c, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
data = dict(np.load(inp))
q, k, v = (jnp.asarray(data["cp/" + n], jnp.bfloat16) for n in "qkv")
s, n, chunk = c["S"], c["world"], c["chunk"]
s_loc = s // n
res = {}
for kind, window, prefix in c["cases"]:
    for rank in range(n):
        off, k_off, klen = rank * s_loc, 0, s
        if kind == "local" and window is not None and window < s:
            klen = min(s, s_loc + -(-window // chunk) * chunk)
            k_off = min(max(off + s_loc - klen, 0), s - klen)
        res[f"{kind}/{rank}"] = np.asarray(RA.flash_attention(
            q[:, off:off + s_loc], k[:, k_off:k_off + klen],
            v[:, k_off:k_off + klen], mask_kind=kind, window=window,
            prefix_len=prefix, q_chunk=min(chunk, s_loc), k_chunk=chunk,
            schedule="masked", q_offset=off, k_offset=k_off), np.float32)
    res[f"{kind}/full"] = np.asarray(RA.flash_attention(
        q, k, v, mask_kind=kind, window=window, prefix_len=prefix,
        q_chunk=chunk, k_chunk=chunk), np.float32)
np.save(out, np.array(res, dtype=object), allow_pickle=True)
"""


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _inputs(path):
    from repro_torch.configs import get_config
    rng = np.random.default_rng(0)
    arrays = {}
    for arch, (name, _, (b, s)) in CASES.items():
        vocab = get_config(name, smoke=True).vocab_size
        arrays[arch + "/tokens"] = rng.integers(0, vocab, (b, s)).astype(
            np.int32)
        arrays[arch + "/labels"] = rng.integers(0, vocab, (b, s)).astype(
            np.int32)
        arrays[arch + "/mask"] = (rng.random((b, s)) < 0.9).astype(
            np.float32)
        toks = rng.integers(0, vocab, (3, b, s // 2 + 1)).astype(np.int32)
        arrays[arch + "/steps/tokens"] = toks[:, :, :-1]
        arrays[arch + "/steps/labels"] = toks[:, :, 1:]
        arrays[arch + "/steps/mask"] = np.ones((3, b, s // 2), np.float32)
    for n, heads in (("q", CP["H"]), ("k", CP["KV"]), ("v", CP["KV"])):
        x = jnp.asarray(rng.standard_normal((CP["B"], CP["S"], heads,
                                             CP["D"])), jnp.bfloat16)
        arrays["cp/" + n] = np.asarray(x, np.float32)
    np.savez(path, **arrays)


def _run(tag, argvs, tmp):
    """Run one process per argv (a world's ranks, or one world-free
    process) under ``LIMIT_S``; each writes ``<tag><i>.npy``, returned
    as a list of dicts."""
    procs = [subprocess.Popen([sys.executable, "-c", *argv,
                               str(tmp / f"{tag}{i}.npy")],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i, argv in enumerate(argvs)]
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=LIMIT_S)
            if p.returncode:
                errors.append(err[-3000:])
    except subprocess.TimeoutExpired:
        errors.append(f"{tag}: a process passed its {LIMIT_S} s limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, errors
    return [np.load(tmp / f"{tag}{i}.npy", allow_pickle=True).item()
            for i in range(len(argvs))]


def _world(script, tag, tmp, inputs, **cfgs):
    """A 4-rank gloo world of ``script``: its ranks' result dicts."""
    cfgs = dict(cfgs, store=str(tmp / f"{tag}.store"), limit=LIMIT_S)
    return _run(tag, [[script, str(r), str(WORLD), str(inputs),
                       json.dumps(cfgs)] for r in range(WORLD)], tmp)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_world")
    _inputs(tmp / "inputs.npz")
    return tmp


@pytest.fixture(scope="module")
def plain(inputs):
    """The mesh-less references of the training cases (no world)."""
    return _run("plain", [[PLAIN, "0", "1", str(inputs / "inputs.npz"),
                           json.dumps({"cases": CASES})]], inputs)[0]


@pytest.fixture(scope="module")
def train_world(inputs):
    return _world(TRAIN_WORLD, "train", inputs, inputs / "inputs.npz",
                  cases=CASES)


def _save_checkpoint(ckdir):
    """The mesh-less checkpoint ``LAYOUT_WORLD`` restores (step 5)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import init_state
    from repro_torch.runtime import trainer as TR
    cfg = get_config("qwen3-32b", smoke=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(7))
    CheckpointManager(ckdir).save(5, TR.state_tree(
        model, init_state(dict(model.named_parameters()))))


@pytest.fixture(scope="module")
def layout_world(inputs):
    ckdir = str(inputs / "ckpt")
    _save_checkpoint(ckdir)
    return _world(LAYOUT_WORLD, "layout", inputs, inputs / "inputs.npz",
                  cp=[(k, w, 64 if k == "prefix" else None)
                      for k, w in CP_CASES],
                  chunk=CP["chunk"], ckpt=ckdir)


@pytest.fixture(scope="module")
def launch_world(inputs):
    ranks = _world(LAUNCH_WORLD, "launch", inputs, inputs / "inputs.npz",
                   train_args=TRAIN_ARGS,
                   train_dir=str(inputs / "train"))
    return ranks, inputs


@pytest.fixture(scope="module")
def cp_reference(inputs):
    cases = [(k, w, 64 if k == "prefix" else None) for k, w in CP_CASES]
    return _run("cp_ref", [[CP_REFERENCE, str(inputs / "inputs.npz"),
                            json.dumps(dict(CP, world=WORLD, cases=cases))]],
                inputs)[0]


def rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_and_moments_take_param_specs(train_world, arch):
    for res in train_world:
        assert res[f"{arch}/placed"] and res[f"{arch}/moments_placed"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_loss_and_gradients_match_the_meshless_step(train_world, plain,
                                                         arch):
    """The loss at the CPU tests' tolerances (float32 1e-5, bf16 1e-3)
    and every float32 gradient leaf within 1e-4 (relative L2) of the
    mesh-less one.  (bf16 gradients are not held here: a mesh sums a
    weight's bf16 gradient from its ranks' bf16 partials, one rounding
    more than the mesh-less product.)"""
    res = train_world[0]
    for tag in ("f32", "bf16"):
        want, got = plain[f"{arch}/{tag}/loss"], res[f"{arch}/{tag}/loss"]
        assert abs(got - want) <= LOSS_RTOL[tag] * abs(want), (tag, got,
                                                               want)
    names = [k.split("/grad/")[1] for k in plain if
             k.startswith(f"{arch}/f32/grad/")]
    assert names
    for n in names:
        truth, f32 = plain[f"{arch}/f32/grad/{n}"], res[f"{arch}/f32/grad/{n}"]
        assert rel_l2(f32, truth) <= F32_GRAD_RTOL, n


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_steps_track_the_meshless_steps(train_world, plain, arch):
    per_rank = train_world[0][f"{arch}/ranks_losses"]
    assert all(losses == per_rank[0] for losses in per_rank)   # the bits
    want = plain[f"{arch}/plain_losses"]
    for got, ref in zip(per_rank[0], want):
        assert abs(got - ref) <= LOSS_RTOL["bf16"] * abs(ref), (got, ref)


def test_exact_accumulation_on_shards_gives_the_whole_sums_bits(train_world):
    res = train_world[0]
    assert res["exact_accum_equal"]
    assert all(r["load_state_dict"] for r in train_world)
    assert np.isfinite(res["exact_step_loss"])


def test_pod_mesh_splits_the_batch_over_both_data_axes(layout_world, plain,
                                                       inputs):
    """Rank r = (pod p, data d) holds global rows [2p + d] of 4: the
    reference's P(("pod", "data")) order, and trains to the mesh-less
    float32 loss."""
    rows = np.load(inputs / "inputs.npz")["qwen3-32b/tokens"]
    for r, res in enumerate(layout_world):
        np.testing.assert_array_equal(res["pod/rows"], rows[r:r + 1])
    want = plain["qwen3-32b/f32/loss"]
    for res in layout_world:
        assert abs(res["pod/loss"] - want) <= LOSS_RTOL["f32"] * want


@pytest.mark.parametrize("kind, window", CP_CASES)
def test_context_parallel_matches_reference(layout_world, cp_reference, kind,
                                            window):
    """Each rank's slice against the reference's ``flash_attention`` of
    that slice with its offsets (the reference test's per-shard call),
    the whole within 0.05 of the reference's full attention."""
    for r, res in enumerate(layout_world):
        want = cp_reference[f"{kind}/{r}"]
        got = res[f"cp/{kind}/local"]
        assert got.shape == want.shape
        # bf16: one ulp apart at most, and near zero the reference's
        # float32 online softmax's own error (the port sums in float64)
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -10)
    full = cp_reference[f"{kind}/full"]
    assert np.abs(layout_world[0][f"cp/{kind}/full"] - full).max() < 0.05


def test_checkpoint_restores_onto_the_mesh(layout_world):
    for res in layout_world:
        assert res["reshard_ok"] and res["reshard_sharded"] > 0


def test_launch_train_model_parallel_tracks_the_meshless_run(launch_world,
                                                             tmp_path):
    ranks, tmp = launch_world
    per_rank = ranks[0]["train/losses"]
    assert all(losses == per_rank[0] for losses in per_rank)
    assert all(res["train/final_step"] == 6 for res in ranks)
    want = LT.main(TRAIN_ARGS + ["--checkpoint-dir", str(tmp_path)]).losses
    assert len(per_rank[0]) == len(want) == 6
    for got, ref in zip(per_rank[0], want):
        assert abs(got - ref) <= LOSS_RTOL["bf16"] * abs(ref), (got, ref)
    assert per_rank[0][-1] < per_rank[0][0]
    from repro_torch.checkpoint import CheckpointManager
    assert CheckpointManager(str(tmp / "train")).latest_step() == 6


def test_launch_train_runs_under_torchrun(launch_world, tmp_path):
    """The launcher's own command line: torchrun's variables make the
    world (gloo under ``--device cpu``), and the four ranks train as the
    world the test made (rank 0 prints its losses)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(WORLD), "--master-addr", "127.0.0.1", "--master-port",
         str(port), "-m", "repro_torch.launch.train", *TRAIN_ARGS,
         "--model-parallel", "2", "--checkpoint-dir", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=LIMIT_S)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "mesh={'data': 2, 'model': 2}" in run.stdout
    want = launch_world[0][0]["train/losses"][0]
    assert (f"done: step=6 loss {want[0]:.3f} -> {want[-1]:.3f}"
            in run.stdout), run.stdout


@pytest.mark.parametrize("arch, groups", [("llama4-scout-17b-a16e", 2),
                                          ("llama4-scout-17b-a16e", 4),
                                          ("dbrx-132b", 2)])
def test_expert_choice_local_matches_reference(arch, groups, monkeypatch):
    """The routing within each of ``groups`` data shards, in one process:
    the reference's on a stand-in mesh (its constraints are layout only,
    so they become the identity)."""
    import types
    monkeypatch.setattr(RM, "constrain", lambda x, *a, **k: x)
    rcfg, rp, tcfg, tp = layer(arch)
    xb, xt = activations(4, 64, rcfg.d_model)
    rxn, rlog, txn, tlog = router_logits(rp, tp, xb, xt, rcfg)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": groups, "model": 1})
    want = np.asarray(RM._expert_choice_local(rp, rxn, rlog, rcfg, mesh),
                      np.float32)
    got = TMOE._expert_choice_local(tp, txn, tlog, tcfg, groups)
    assert got.dtype == torch.bfloat16 and got.shape == txn.shape
    assert rel_err(got.float().numpy(), want) < 0.02
    if groups > 1 and arch.startswith("llama4"):   # a real regrouping
        one = TMOE._expert_choice_local(tp, txn, tlog, tcfg, 1)
        assert not torch.equal(one, got)
