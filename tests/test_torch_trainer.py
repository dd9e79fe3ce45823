"""The port's trainer (``repro_torch.runtime``) and training CLI
(``repro_torch.launch.train``) on the CPU: mirrors of
``tests/test_trainer.py`` (the loss falls, resume, the non-finite guard,
exact accumulation, SIGTERM), and three steps of the port's train step
beside the reference's on the same parameters and batches.
"""
import os
import signal

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import build_model as r_build
from repro.optim import AdamWConfig as RAdamW
from repro.optim import init_state as r_init_state
from repro.runtime import make_train_step as r_make_train_step
from repro_torch import configs as TCFG
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, PatternLM
from repro_torch.launch import train as LT
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.runtime import TrainerConfig, make_train_step, train
from repro_torch.runtime import trainer as TR

from test_torch_models import port_model, ref_params


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


def _setup(tmp_path, steps=8, **tkw):
    cfg = TCFG.get_config("qwen3-32b", smoke=True)
    model = build_model(cfg, "cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                      source="pattern")
    src = PatternLM(data, device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    tcfg = TrainerConfig(steps=steps, checkpoint_every=4,
                         checkpoint_dir=str(tmp_path), log_every=0, **tkw)
    return model, src, opt, tcfg


def _batch(cfg, rows, seed, mask=1.0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, rows, 64)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[0]),
            "labels": torch.from_numpy(toks[1]),
            "mask": torch.full((rows, 64), mask)}


def test_train_loss_decreases(tmp_path):
    model, src, opt, tcfg = _setup(tmp_path, steps=10)
    res = train(model, src, opt, tcfg, resume=False)
    assert res.final_step == 10
    assert res.skipped_steps == 0
    assert len(res.step_seconds) == len(res.losses) == 10
    assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3])


def test_resume_from_checkpoint(tmp_path):
    model, src, opt, tcfg = _setup(tmp_path, steps=4)
    res1 = train(model, src, opt, tcfg, resume=False)
    assert res1.final_step == 4
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    # second run continues to step 8 from the saved step-4 state
    tcfg2 = TrainerConfig(steps=8, checkpoint_every=4,
                          checkpoint_dir=str(tmp_path), log_every=0)
    fresh = build_model(model.cfg, "cpu")
    opt_state = init_state(dict(fresh.named_parameters()))
    TR.load_state(fresh, opt_state, CheckpointManager(str(tmp_path)).restore(
        4, TR._like_tree(model.cfg)))
    assert all(torch.equal(fresh.state_dict()[k], saved[k]) for k in saved)
    assert int(opt_state["step"]) == 4
    res2 = train(model, src, opt, tcfg2, resume=True, seed=99)
    assert res2.final_step == 8
    assert len(res2.losses) == 4            # only steps 4..7 executed


def test_nonfinite_grad_guard():
    cfg = TCFG.get_config("qwen3-32b", smoke=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=0))
    state = init_state(dict(model.named_parameters()))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    stats = step_fn(state, _batch(cfg, 2, 0, mask=float("inf")))
    assert not stats["finite"]
    # params and moments unchanged on the poisoned step; the step counts
    assert all(torch.equal(model.state_dict()[k], before[k]) for k in before)
    assert not any(t.any() for key in ("m", "v") for t in state[key].values())
    assert int(state["step"]) == 1
    stats = step_fn(state, _batch(cfg, 2, 0))
    assert stats["finite"] and int(state["step"]) == 2
    assert not all(torch.equal(model.state_dict()[k], before[k])
                   for k in before)


def test_exact_accum_microbatches_match_order():
    """MCIM fixed-point accumulation: microbatch order cannot matter."""
    cfg = TCFG.get_config("mamba2-370m", smoke=True)
    batch = _batch(cfg, 4, 1)
    out = []
    for perm in ([0, 1, 2, 3], [2, 3, 0, 1]):     # swap the halves
        model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
        fn = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=0),
                             microbatches=2, exact_accum=True)
        stats = fn(init_state(dict(model.named_parameters())),
                   {k: v[perm] for k, v in batch.items()})
        out.append((stats["loss"], model.state_dict()))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])


class _SigtermAt:
    """A source that sends this process SIGTERM when step ``at``'s batch
    is drawn (no wall clock, so nothing races)."""

    def __init__(self, src, at):
        self.src, self.at = src, at

    def batch_at(self, step):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.src.batch_at(step)


def test_sigterm_triggers_checkpoint(tmp_path):
    """Preemption handling: SIGTERM mid-training checkpoints and stops."""
    model, src, opt, tcfg = _setup(tmp_path, steps=200)
    before = signal.getsignal(signal.SIGTERM)
    res = train(model, _SigtermAt(src, 5), opt, tcfg, resume=False)
    # the step in flight finishes; a restorable checkpoint at the stop
    assert res.final_step == 6 and len(res.losses) == 6
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
    assert signal.getsignal(signal.SIGTERM) is before


def test_train_step_tracks_the_reference():
    """Three steps of the port's train step and the reference's on the
    same parameters and batches (two microbatches): each step's loss
    within 1e-3, and the parameters after them within 2e-2 (relative L2
    a leaf; bf16 updates round apart by an ulp now and then)."""
    arch = "gemma2-9b"
    rcfg = RCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    r_step = r_make_train_step(r_build(rcfg), RAdamW(**kw), microbatches=2)
    r_state = r_init_state(params)
    model = port_model(arch, params)
    step = make_train_step(model, AdamWConfig(**kw), microbatches=2)
    state = init_state(dict(model.named_parameters()))
    for i in range(3):
        b = _batch(rcfg, 4, 10 + i)
        params, r_state, r_stats = r_step(
            params, r_state, {k: jnp.asarray(v.numpy()) for k, v in
                              b.items()})
        stats = step(state, b)
        assert abs(stats["loss"] - float(r_stats["loss"])) <= \
            1e-3 * float(r_stats["loss"]), i
    want = port_model(arch, params).state_dict()
    for name, t in model.state_dict().items():
        got, ref = t.float().numpy(), want[name].float().numpy()
        assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref), name


def test_launch_train_cli_loss_falls(tmp_path, capsys):
    res = LT.main(["--arch", "qwen3-32b", "--smoke", "--steps", "20",
                   "--source", "pattern", "--device", "cpu", "--no-resume",
                   "--checkpoint-dir", str(tmp_path)])
    assert res.final_step == 20 and res.skipped_steps == 0
    assert res.losses[-1] < res.losses[0]
    assert "[train] done: step=20" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).latest_step() == 20


def test_launch_train_refuses_model_parallel():
    """One process has no model axis to split: ``--model-parallel 2``
    needs a world of several ranks (the mesh path's runs:
    ``tests/test_torch_mesh_world.py``)."""
    with pytest.raises(ValueError, match="world of several ranks"):
        LT.main(["--smoke", "--model-parallel", "2", "--device", "cpu"])


def test_launch_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LT.main(["--smoke", "--steps", "1"])


def test_maybe_init_distributed_is_a_no_op_alone(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    TR.maybe_init_distributed()
    assert not torch.distributed.is_initialized()


def test_maybe_init_distributed_takes_a_card_a_rank(monkeypatch):
    """Under the launcher's variables each rank binds the card
    ``LOCAL_RANK`` before NCCL starts; a rank with no card of its own
    raises, and a CPU device starts gloo."""
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="no card of its own"):
        TR.maybe_init_distributed()
    assert calls == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    TR.maybe_init_distributed()
    assert calls == [2, ("nccl", {"device_id": torch.device("cuda", 2)})]
    calls.clear()
    TR.maybe_init_distributed("cpu")
    assert calls == [("gloo", {})]
