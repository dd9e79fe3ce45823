"""``repro_torch.launch.serve`` against the JAX package's ServeEngine.

Both engines serve the same prompts with the same parameters, driven by
the same loop (:func:`repro_torch.launch.serve.serve`, the reference's
``main`` loop).  Held equal: the arrival, completion and latency traces,
the engine cycle and the bank replay's report.  Tokens: every request's
tokens equal the reference's up to the first step where the reference's
top-2 logit margin is within twice the tolerance (a tie the two packages
may break apart; the sequences diverge from there); until then each
step's logits agree within the tolerance, max|d| / std(reference): 0.05
dense, 0.1 gemma2, 0.25 with the int8 KV cache, and the reference's
decode-consistency tolerances for the other token families (0.08 MoE,
0.05 mamba2, 0.12 zamba2).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import repro.verify
from repro import designs as RD
from repro.configs import get_config as r_config
from repro.launch import serve as RS
from repro.models import base as RB
from repro.models import build_model as r_build
from repro.rng import random_tokens as r_random_tokens
from repro_torch import designs as TD
from repro_torch.configs import get_config as t_config
from repro_torch.launch import serve as TS
from repro_torch.models import build_model, params_from_numpy
from repro_torch.rng import random_tokens

TOL = {"qwen3-32b": 0.05, "minitron-8b": 0.05, "gemma3-1b": 0.05,
       "gemma2-9b": 0.1, "dbrx-132b": 0.08, "llama4-scout-17b-a16e": 0.08,
       "mamba2-370m": 0.05, "zamba2-1.2b": 0.12}


def ref_params(cfg, seed=0):
    """Uniform numpy draws with the initializers' standard deviations,
    in each leaf's dtype (bf16, or float32); norm scales nonzero."""
    rng = np.random.default_rng(seed)

    def one(p):
        x = (rng.random(p.shape, dtype=np.float32) - 0.5) * math.sqrt(12.0)
        std = 0.1 if p.init == "zeros" else 1 / math.sqrt(
            p.shape[-2]) if p.init == "scaled" else p.scale
        return jnp.asarray(x * std, p.dtype)
    return jax.tree_util.tree_map(one, r_build(cfg).template(),
                                  is_leaf=RB.is_param)


def prompts(n, length, vocab):
    """The reference CLI's prompts, from the port's Philox."""
    return [random_tokens(7, r, torch.arange(length), vocab).numpy()
            for r in range(n)]


class Recording:
    """A model whose prefill / decode logits are kept (float32 numpy)."""

    def __init__(self, inner):
        self.inner = inner
        self.prefills, self.steps = [], []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def prefill(self, *args, **kwargs):
        caches, logits = self.inner.prefill(*args, **kwargs)
        self.prefills.append(np.asarray(_f32(logits)))
        return caches, logits

    def decode_step(self, *args, **kwargs):
        caches, logits = self.inner.decode_step(*args, **kwargs)
        self.steps.append(np.asarray(_f32(logits)))
        return caches, logits


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _record_steps(eng):
    """Wrap ``eng.step`` to keep (live, request_of_slot) of every step."""
    eng.slot_log = []
    step = eng.step

    def logged():
        eng.slot_log.append((eng.live.copy(), list(eng.request_of_slot)))
        step()
    eng.step = logged


def per_request_logits(eng, rec):
    """request id -> the logits rows that chose its tokens, in order."""
    rows = {}
    order = iter(rid for rid, _ in eng._arrivals)
    for logits in rec.prefills:       # one prompt length: arrival order
        for row in logits:
            rows[next(order)] = [row]
    for logits, (live, owners) in zip(rec.steps, eng.slot_log):
        for slot, rid in enumerate(owners):
            if live[slot]:
                rows[rid].append(logits[slot])
    return rows


def run_both(arch, n_req, slots, prompt_len, max_new, **overrides):
    rcfg = r_config(arch, smoke=True, **overrides)
    tcfg = t_config(arch, smoke=True, **overrides)
    params = ref_params(rcfg)
    s_cap = prompt_len + max_new + 8
    ps = prompts(n_req, prompt_len, rcfg.vocab_size)

    rmodel = r_build(rcfg)
    reng = RS.ServeEngine(rmodel, params, slots, prompt_len, s_cap)
    rrec = reng.model = Recording(rmodel)     # its decode is jitted:
    decode = reng._decode                     # record around the jit

    def recorded_decode(*args):
        caches, logits = decode(*args)
        rrec.steps.append(_f32(logits))
        return caches, logits
    reng._decode = recorded_decode
    _record_steps(reng)
    TS.serve(reng, ps, max_new)

    model = build_model(tcfg, "cpu")
    model.load_state_dict(params_from_numpy(
        tcfg, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                     params), "cpu"))
    trec = Recording(model)
    teng = TS.ServeEngine(trec, slots, prompt_len, s_cap)
    _record_steps(teng)
    TS.serve(teng, ps, max_new)
    return (reng, rrec), (teng, trec)


def check_tokens(ref, port, tol):
    (reng, rrec), (teng, trec) = ref, port
    rrows = per_request_logits(reng, rrec)
    trows = per_request_logits(teng, trec)
    compared = 0
    for rid, want in reng.outputs.items():
        got = teng.outputs[rid]
        assert len(got) == len(want) == len(rrows[rid]) == len(trows[rid])
        for t, (r, g) in enumerate(zip(rrows[rid], trows[rid])):
            scale = max(np.std(r), 1e-3)
            assert np.abs(g - r).max() / scale < tol, (rid, t)
            top2 = np.sort(r)[-2:]
            compared += 1
            if got[t] != want[t]:
                assert top2[1] - top2[0] <= 2 * tol * scale, (rid, t)
                break                  # the sequences diverge from here
    return compared


@pytest.mark.parametrize("arch,n_req,slots,prompt_len,max_new,kv", [
    ("qwen3-32b", 5, 4, 8, 16, "bf16"),     # the dead-slot run
    ("minitron-8b", 3, 2, 8, 4, "bf16"),
    ("gemma3-1b", 3, 2, 72, 6, "bf16"),     # prompt past the 64 window
    ("gemma2-9b", 3, 2, 8, 6, "bf16"),
    ("qwen3-32b", 3, 2, 8, 6, "int8"),
    # 2 x 16 tokens > 4 x 4 experts: the first burst's prefill takes
    # expert choice, the third request's (16 tokens) token choice
    ("dbrx-132b", 3, 2, 16, 6, "bf16"),
    ("llama4-scout-17b-a16e", 3, 2, 16, 6, "bf16"),
    ("mamba2-370m", 3, 2, 40, 6, "bf16"),   # past one 32-token chunk
    ("zamba2-1.2b", 3, 2, 40, 6, "bf16"),
])
def test_engine_matches_reference(arch, n_req, slots, prompt_len, max_new,
                                  kv):
    ref, port = run_both(arch, n_req, slots, prompt_len, max_new,
                         kv_cache_dtype=kv)
    reng, teng = ref[0], port[0]
    assert teng.arrival_trace() == reng.arrival_trace()
    assert teng.completion_trace() == reng.completion_trace()
    assert teng.latency_trace() == reng.latency_trace()
    assert teng.cycle == reng.cycle
    assert teng.pos.tolist() == np.asarray(reng.pos).tolist()
    assert sorted(teng.outputs) == sorted(reng.outputs) == list(range(n_req))
    tol = 0.25 if kv == "int8" else TOL[arch]
    assert check_tokens(ref, port, tol) >= n_req


def test_dead_slots_step_past_the_cache():
    """5 requests on 4 slots: the 3 finished slots keep stepping until the
    fifth request ends, so their pos passes s_cap = 32 (the reference ends
    at pos [24 40 40 40]); their writes are dropped, the live slot's
    tokens stay the reference's."""
    ref, port = run_both("qwen3-32b", 5, 4, 8, 16)
    assert np.asarray(ref[0].pos).tolist() == [24, 40, 40, 40]
    assert port[0].pos.tolist() == [24, 40, 40, 40]
    assert port[0].outputs[4] == ref[0].outputs[4]
    assert port[0].completion_trace() == (16, 16, 16, 16, 32)


def test_prompts_equal_the_reference_cli():
    for r in range(3):
        want = np.asarray(r_random_tokens(
            7, r, jnp.arange(32, dtype=jnp.uint32), 256_000))
        np.testing.assert_array_equal(prompts(r + 1, 32, 256_000)[r], want)


def test_main_serves_and_replays_like_the_reference(monkeypatch, capsys):
    monkeypatch.setattr(repro.verify, "assert_plan_dataflow",
                        lambda *a, **k: None)
    argv = ["--arch", "gemma2-9b", "--smoke", "--requests", "3",
            "--slots", "2", "--prompt-len", "8", "--max-new", "4"]
    eng = TS.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 15 tokens" in out
    assert "mcim replay of 3 admissions over 8 engine cycles" in out
    reng = RS.main(argv + ["--mcim-design", "none"])
    assert eng.arrival_trace() == reng.arrival_trace() == (0, 0, 4)
    assert eng.completion_trace() == reng.completion_trace()
    assert eng.latency_trace() == reng.latency_trace()
    assert eng.cycle == reng.cycle
    rep = TD.generate("tp3p5_w32", device="cpu").replay(eng.arrival_trace())
    want = RD.generate("tp3p5_w32").replay(reng.arrival_trace())
    for f in ("batch", "cycles", "plan_throughput", "working_set_bytes",
              "scheduler", "latency_hist", "energy_per_op_pj",
              "peak_power_mw", "measured_throughput", "latency_p50",
              "latency_p99"):
        assert getattr(rep, f) == getattr(want, f), f
    assert [(dataclasses.asdict(i.config), i.n_ops, i.busy_cycles)
            for i in rep.instances] == \
        [(dataclasses.asdict(i.config), i.n_ops, i.busy_cycles)
         for i in want.instances]


@pytest.mark.parametrize("arch,needs", [
    ("hubert-xlarge", "frames and has no decode step"),
    ("paligemma-3b", "image embeddings")])
def test_main_refuses_the_families_it_cannot_feed(arch, needs):
    with pytest.raises(ValueError, match=needs) as err:
        TS.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert "dense, moe, ssm, hybrid" in str(err.value)


def test_engine_refuses_more_requests_than_free_slots():
    model = build_model(t_config("qwen3-32b", smoke=True), "cpu")
    model.init(torch.Generator().manual_seed(0))
    eng = TS.ServeEngine(model, 2, 8, 16)
    ps = prompts(3, 8, 512)
    with pytest.raises(ValueError, match="free slots"):
        eng.admit_many(list(enumerate(ps)))
    assert eng.arrival_trace() == ()
    eng.admit(0, ps[0])
    assert eng.live.tolist() == [True, False] and eng.pos.tolist() == [8, 0]
