"""Serving on a mesh: ``ServeEngine(mesh=...)`` (``Model.prefill`` and
``decode_step`` on DTensor caches at ``launch.sharding.cache_specs``'
placements) in a 4-rank ``gloo`` world on the CPU, held to the mesh-less
port and to the reference.

One world is spawned for the module; each rank writes its results and
the tests read rank 0's.  Float32 smoke models with the reference's
parameters (bf16 values; the caches stay bf16, as the reference's; the
reference itself runs them in their template dtypes):

* qwen3-32b (kv heads split over "model"), gemma3-1b (one kv head: the
  cache splits head_dim, the scores are partial sums over "model"),
  llama4-scout with token choice, zamba2-1.2b (the hybrid's SSM and
  shared-attention caches) and qwen3-32b with the int8 KV cache: four
  slots on a (2, 2) ("data", "model") mesh, admitted as a burst of 1 and
  a burst of 3 (neither divides the data axis: their prefills are
  replicated there while the slot caches are split), then 8 steps.  The
  prefill logits match the mesh-less engine's to 1e-5 relative; the
  decode steps' within 2e-3 of the logits' largest magnitude (a float32
  key that parts by an ulp can round to the other bf16 value in the
  cache), with the same greedy tokens; the caches, ``cur`` and ``pos``
  sit at ``cache_specs``' and ``batch_spec``'s placements, and every
  step's logits are within the reference's serving tolerances of the
  reference's ``prefill``/``decode_step`` (mesh=None) fed the same
  tokens;
* one slot (batch 1): the caches split their sequence over "data" and
  decode merges the ranks' stretches as a log-sum-exp (gemma3-1b with a
  72-token prompt past its 64-slot ring, and the int8 cache);
* a (1, 1) mesh in a one-rank world serves bit for bit as the mesh-less
  engine;
* paligemma-3b's prefill and decode step and hubert-xlarge's forward on
  (2, 2) against mesh=None (the rules above);
* the collectives one rank of the world counts (``op_cost``) in a real
  train step and decode step on the (2, 2) mesh, which
  ``test_torch_dryrun.py`` holds the fake world's counts to.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as RCFG
from repro.models import build_model as r_build

from test_torch_models import as_numpy, ref_params, rel_err

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
LIMIT_S = 600
SLOTS, S_CAP, STEPS = 4, 32, 8
#: case -> (config, overrides, prompt length): llama4-scout's prompts
#: keep every prefill at most 4 tokens an expert (token choice)
CASES = {
    "qwen3-32b": ("qwen3-32b", {}, 8),
    "gemma3-1b": ("gemma3-1b", {}, 8),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}, 4),
    "zamba2-1.2b": ("zamba2-1.2b", {}, 8),
    "qwen3-32b-int8": ("qwen3-32b", {"kv_cache_dtype": "int8"}, 8),
}
#: one slot: (config, overrides, prompt length, s_cap)
SEQ_CASES = {
    "gemma3-1b": ("gemma3-1b", {}, 72, 96),
    "qwen3-32b-int8": ("qwen3-32b", {"kv_cache_dtype": "int8"}, 20, 32),
}
PREFILL_RTOL = 1e-5
DECODE_RTOL = 2e-3
#: the reference's serving tolerances (tests/test_torch_launch_serve.py)
REF_TOL = {"qwen3-32b": 0.05, "gemma3-1b": 0.05,
           "llama4-scout-17b-a16e": 0.08, "zamba2-1.2b": 0.12,
           "qwen3-32b-int8": 0.25}

RANK = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.sharding import batch_spec, cache_specs
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.base import placements
from repro_torch.optim import AdamWConfig, apply_updates, init_state
from repro_torch.runtime import make_train_step
from repro_torch.data import device_batch

rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
cfgs = json.loads(sys.argv[6])
torch.set_num_threads(1)
data = dict(np.load(inp, allow_pickle=True))
res = {}


def tree_of(name):
    return data[name + "/params"].item()


def model_of(name, over, mesh):
    cfg = get_config(cfgs["archs"][name], smoke=True, **over)
    m = build_model(cfg, "cpu")
    m.load_state_dict(params_from_numpy(cfg, tree_of(name), "cpu"))
    m.float()
    return m.distribute_(mesh) if mesh is not None else m


def full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).float()


def drive(name, over, mesh, prompts, bursts, s_cap, steps):
    # (logits of each prefill and step, greedy tokens a step, engine)
    model = model_of(name, over, mesh)
    seen = []
    prefill, decode = model.prefill, model.decode_step

    def rec_prefill(*a, **k):
        caches, logits = prefill(*a, **k)
        seen.append(full(logits).numpy())
        return caches, logits

    def rec_decode(*a, **k):
        caches, logits = decode(*a, **k)
        seen.append(full(logits).numpy())
        return caches, logits
    model.prefill, model.decode_step = rec_prefill, rec_decode
    eng = ServeEngine(model, len(prompts), prompts[0].shape[0], s_cap,
                      mesh=mesh)
    first = 0
    for n in bursts:
        eng.admit_many([(first + i, prompts[first + i]) for i in range(n)])
        first += n
    toks = []
    for _ in range(steps):
        toks.append(full(eng.cur).long().numpy())
        eng.step()
    return seen, np.stack(toks), eng


def placed_right(eng, mesh):
    specs = cache_specs(eng.model.cache_spec(eng.slots, eng.s_cap), mesh)
    ok = all(buf.placements == placements(specs[i][n], mesh)
             for i, layer in enumerate(eng.caches)
             for n, buf in layer.items())
    want = placements(batch_spec(mesh, 1, eng.slots), mesh)
    return bool(ok and eng.cur.placements == want
                and eng.pos.placements == want)


dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_host_mesh(2, "cpu")
for name, (_, over, plen) in cfgs["cases"].items():
    prompts = list(data[name + "/prompts"])
    got, toks, eng = drive(name, over, mesh, prompts, [1, 3], cfgs["s_cap"],
                           cfgs["steps"])
    want, want_toks, _ = drive(name, over, None, prompts, [1, 3],
                               cfgs["s_cap"], cfgs["steps"])
    res[name] = {"mesh": got, "plain": want, "tokens": toks,
                 "plain_tokens": want_toks, "placed": placed_right(eng, mesh),
                 "outputs": eng.outputs}
for name, (_, over, plen, s_cap) in cfgs["seq_cases"].items():
    prompts = list(data["seq/" + name + "/prompts"])
    got, toks, eng = drive(name, over, mesh, prompts, [1], s_cap,
                           cfgs["steps"])
    want, want_toks, _ = drive(name, over, None, prompts, [1], s_cap,
                               cfgs["steps"])
    layout = [buf.placements[0].is_shard(1)
              for layer in eng.caches for buf in layer.values()]
    res["seq/" + name] = {"mesh": got, "plain": want, "tokens": toks,
                          "plain_tokens": want_toks, "layout": layout}

# the VLM's prefill and decode step, the encoder's forward (mesh=None
# against the mesh, float32 smoke models)
rng = np.random.default_rng(4)
for arch in ("paligemma-3b", "hubert-xlarge"):
    cfg = get_config(arch, smoke=True)
    plain, meshed = (build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0)).float() for _ in range(2))
    meshed.distribute_(mesh)
    if arch == "paligemma-3b":
        batch = {"image_embeds": torch.from_numpy(rng.standard_normal(
            (2, cfg.n_vis_tokens, cfg.d_vis)).astype(np.float32)),
            "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (2, 8)))}
        c0, l0 = plain.prefill(batch, s_cap=32)
        c1, l1 = meshed.prefill(batch, s_cap=32, mesh=mesh)
        tok = l0.argmax(-1)
        pos = torch.full((2,), cfg.n_vis_tokens + 8)
        _, d0 = plain.decode_step(c0, tok, pos)
        _, d1 = meshed.decode_step(c1, tok, pos, mesh=mesh)
        pairs = [(l0, l1), (d0, d1)]
    else:
        batch = {"frames": torch.from_numpy(rng.standard_normal(
            (2, 16, 512)).astype(np.float32))}
        pairs = [(plain.prefill(batch)[1],
                  meshed.prefill(batch, mesh=mesh)[1])]
    res["family/" + arch] = [(full(b).numpy(), a.numpy()) for a, b in pairs]

# the collectives one rank counts in a real train and decode step
from repro_torch.configs.base import ShapeCfg
for kind, arch in (("train", "qwen3-32b"), ("decode", "gemma3-1b")):
    cfg = get_config(arch, smoke=True)
    shape = ShapeCfg("mini_" + kind, 64, 4, kind)
    model = build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0)).distribute_(mesh)
    dev = torch.device("cpu")
    if kind == "train":
        step = make_train_step(model, AdamWConfig(), mesh)
        named = dict(model.named_parameters())
        state = init_state(named)
        toks = torch.randint(0, cfg.vocab_size, (4, 64),
                             generator=torch.Generator().manual_seed(1))
        batch = device_batch({"tokens": toks, "labels": toks,
                              "mask": torch.ones(4, 64)}, mesh=mesh)

        def fn():
            loss, grads, _ = step.gradients(batch)
            apply_updates(named, dict(zip(named, grads)), state,
                          AdamWConfig())
    else:
        caches = model.init_cache(4, 64, mesh)
        token = torch.zeros(4, dtype=torch.int64)
        pos = torch.arange(4, dtype=torch.int64)

        def fn():
            model.decode_step(caches, token, pos, mesh=mesh)
    counted = op_cost.analyze(fn)
    res["real/" + kind] = {k: [v["count"], v["result_bytes"]]
                           for k, v in counted["collectives"].items()}
dist.barrier()
dist.destroy_process_group()

# a (1, 1) mesh in a world of one
if rank == 0:
    dist.init_process_group("gloo", init_method="file://" + store + ".one",
                            rank=0, world_size=1)
    one = make_host_mesh(1, "cpu")
    for name in ("qwen3-32b", "gemma3-1b", "zamba2-1.2b"):
        _, over, plen = cfgs["cases"][name]
        prompts = list(data[name + "/prompts"])
        got, toks, _ = drive(name, over, one, prompts, [1, 3],
                             cfgs["s_cap"], cfgs["steps"])
        want, want_toks, _ = drive(name, over, None, prompts, [1, 3],
                                   cfgs["s_cap"], cfgs["steps"])
        res["one/" + name] = all(np.array_equal(a, b)
                                 for a, b in zip(got, want)) and \
            np.array_equal(toks, want_toks) and len(got) == len(want)
    dist.destroy_process_group()
    np.save(out, np.array(res, dtype=object), allow_pickle=True)
"""


def _inputs(path):
    rng = np.random.default_rng(3)
    arrays = {}
    for name, (arch, over, plen) in CASES.items():
        cfg = RCFG.get_config(arch, smoke=True, **over)
        arrays[name + "/params"] = np.array(as_numpy(ref_params(cfg)),
                                            dtype=object)
        arrays[name + "/prompts"] = rng.integers(
            0, cfg.vocab_size, (SLOTS, plen)).astype(np.int64)
    for name, (arch, over, plen, _) in SEQ_CASES.items():
        cfg = RCFG.get_config(arch, smoke=True, **over)
        arrays["seq/" + name + "/prompts"] = rng.integers(
            0, cfg.vocab_size, (1, plen)).astype(np.int64)
    np.savez(path, **arrays)
    return {k: (v.item() if v.dtype == object else v)
            for k, v in arrays.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    inp = tmp / "inputs.npz"
    arrays = _inputs(inp)
    archs = {name: c[0] for name, c in list(CASES.items())
             + list(SEQ_CASES.items())}
    cfgs = {"cases": CASES, "seq_cases": SEQ_CASES, "archs": archs,
            "s_cap": S_CAP, "steps": STEPS}
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(WORLD), str(tmp / "store"),
         str(inp), str(tmp / "rank0.npy"), json.dumps(cfgs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=LIMIT_S)
            if p.returncode:
                errors.append(err[-3000:])
    except subprocess.TimeoutExpired:
        errors.append(f"a rank passed its {LIMIT_S} s limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, errors
    return np.load(tmp / "rank0.npy", allow_pickle=True).item(), arrays


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_logits(name, arrays, res):
    """The reference's prefill of the four prompts, then its decode steps
    fed the mesh engine's tokens (mesh=None; its parameters in their
    template dtypes: the reference writes its bf16 caches from bf16
    keys only)."""
    arch, over, plen = CASES[name]
    cfg = RCFG.get_config(arch, smoke=True, **over)
    params = ref_params(cfg)
    model = r_build(cfg)
    caches, logits = jax.jit(lambda p, t: model.prefill(
        p, {"tokens": t}, s_cap=S_CAP))(
            params, jnp.asarray(arrays[name + "/prompts"], jnp.int32))
    out = [np.asarray(logits, np.float32)]
    decode = jax.jit(model.decode_step)
    for j, toks in enumerate(res["tokens"]):
        caches, logits = decode(params, caches, jnp.asarray(toks, jnp.int32),
                                jnp.full((SLOTS,), plen + j, jnp.int32))
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_engine_matches_the_meshless_engine(world, name):
    res = world[0][name]
    got, want = res["mesh"], res["plain"]
    assert len(got) == len(want) == 2 + STEPS
    for a, b in zip(got[:2], want[:2]):          # the two bursts' prefills
        assert _rel(a, b) < PREFILL_RTOL, name
    for j, (a, b) in enumerate(zip(got[2:], want[2:])):
        assert _rel(a, b) < DECODE_RTOL, (name, j)
    assert np.array_equal(res["tokens"], res["plain_tokens"])
    assert res["placed"]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_engine_matches_the_reference(world, name):
    res, arrays = world[0][name], world[1]
    got = [np.concatenate(res["mesh"][:2])] + res["mesh"][2:]
    tol = REF_TOL[name]
    for j, (a, b) in enumerate(zip(got, _ref_logits(name, arrays, res))):
        assert a.shape == b.shape
        assert rel_err(a, b) < tol, (name, j)


@pytest.mark.parametrize("name", list(SEQ_CASES))
def test_batch_one_cache_splits_its_sequence(world, name):
    res = world[0]["seq/" + name]
    assert all(res["layout"]), res["layout"]      # S -> "data"
    got, want = res["mesh"], res["plain"]
    assert _rel(got[0], want[0]) < PREFILL_RTOL
    for j, (a, b) in enumerate(zip(got[1:], want[1:])):
        assert _rel(a, b) < DECODE_RTOL, (name, j)
    assert np.array_equal(res["tokens"], res["plain_tokens"])


@pytest.mark.parametrize("name", ["qwen3-32b", "gemma3-1b", "zamba2-1.2b"])
def test_one_rank_mesh_is_bit_for_bit(world, name):
    assert world[0]["one/" + name] is True


@pytest.mark.parametrize("kind, arch", [("train", "qwen3-32b"),
                                        ("decode", "gemma3-1b")])
def test_fake_world_counts_the_real_worlds_collectives(world, kind, arch):
    """The dry run's (2, 2) fake world against rank 0 of the real gloo
    world counting the same step: collectives by type and result bytes."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.dryrun import run_cell
    res = run_cell(arch, None, "mini", mesh=((2, 2), ("data", "model")),
                   shape_cfg=ShapeCfg("mini_" + kind, 64, 4, kind),
                   smoke=True, device_type="cpu")
    got = {k: [v["count"], v["result_bytes"]]
           for k, v in res["collectives"].items()}
    assert got == world[0]["real/" + kind]
    assert sum(c for c, _ in got.values()) > 0


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_vlm_and_encoder_serve_on_the_mesh(world, arch):
    """The VLM's prefill and decode step and the encoder's forward on the
    (2, 2) mesh against mesh=None, float32: the prefill and forward to
    1e-5 relative, the decode step (bf16 caches) to the decode rule."""
    for j, (got, want) in enumerate(world[0]["family/" + arch]):
        assert got.shape == want.shape
        assert _rel(got, want) < (PREFILL_RTOL if j == 0 else DECODE_RTOL)
