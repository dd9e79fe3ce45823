"""Replicated banks and the determinism path on the card, each equal to
the same call on the CPU.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one; nothing imports jax, so ``python -m pytest -m cuda
tests/test_torch_sharded_cuda.py`` runs on a machine without it.  The
CPU side of each comparison is held to the JAX reference by
``tests/test_torch_{sharded_bank,designs,exact,collectives,rng_data}.py``.
"""
import dataclasses
import datetime
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import data, designs
from repro_torch.core import limbs as L
from repro_torch.core import planner
from repro_torch.core.bank import Bank, sharded_execute
from repro_torch.exact import exact_psum, exact_sum, f32_to_fixed, \
    fixed_to_f32
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.optim.compress import compressed_psum, init_error
from repro_torch.rng import philox4x32, random_u32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (the CPU path is their plain version)")
    return torch.device("cuda", torch.cuda.current_device())


def _replica_layouts(device):
    """Two replicas on one card, and on two cards where there are two."""
    layouts = [[device] * 2]
    if torch.cuda.device_count() >= 2:
        layouts.append([torch.device("cuda", i) for i in range(2)])
    return layouts


@pytest.mark.parametrize("backend", ("fused", "kernel"))
def test_sharded_execute_on_the_card_matches_the_cpu(cuda_device, backend):
    """Each replica launches its bank's kernels for its shard; the
    products come back on the operands' card, equal to the CPU's."""
    plan = planner.plan_throughput(128, 128, Fraction(5, 6))
    rng = np.random.default_rng(1)
    a = L.from_numpy(L.random_limbs(rng, (4096,), 128), "cpu")
    b = L.from_numpy(L.random_limbs(rng, (4096,), 128), "cpu")
    want = sharded_execute(plan, a, b, ["cpu"] * 2, backend="core")
    for devices in _replica_layouts(cuda_device):
        reset_launch_counts()
        got = sharded_execute(plan, a.to(cuda_device), b.to(cuda_device),
                              devices, backend=backend)
        torch.cuda.synchronize()
        assert got.device == cuda_device
        assert torch.equal(got.cpu(), want)
        per_replica = Bank(plan, 128, 128, backend=backend,
                           device=devices[0]).launch_count(2048)
        assert per_replica > 0
        assert sum(launch_counts().values()) == 2 * per_replica


@pytest.mark.parametrize("name", ("tp3p5_w32", "tp5over6_w128"))
def test_replicated_design_on_the_card_matches_the_cpu(cuda_device, name):
    # the same capability on both sides: auto would pick the plain core
    # bank on the CPU, whose report counts another working set
    spec = dataclasses.replace(designs.get(name), replicas=2,
                               backend="fused")
    on_cpu = designs.generate(spec, device="cpu")
    rng = np.random.default_rng(2)
    a = L.random_limbs(rng, (1000,), spec.bits_a)
    b = L.random_limbs(rng, (1000,), spec.bits_b)
    want = on_cpu.mul(L.from_numpy(a, "cpu"), L.from_numpy(b, "cpu"))
    for devices in _replica_layouts(cuda_device):
        d = designs.generate(spec, devices=devices)
        assert d.bank.backend == "fused"
        reset_launch_counts()
        got = d.mul(L.from_numpy(a, cuda_device), L.from_numpy(b, cuda_device))
        torch.cuda.synchronize()
        assert launch_counts()["bank_fold"] == 2
        assert torch.equal(got.cpu(), want)
        for prop in ("throughput", "area", "peak_power_mw"):
            assert getattr(d, prop) == getattr(on_cpu, prop)
        assert dataclasses.asdict(d.report(1000)) == \
            dataclasses.asdict(on_cpu.report(1000))
    with pytest.raises(designs.DesignError):
        designs.generate(dataclasses.replace(
            spec, replicas=torch.cuda.device_count() + 1))


def test_fixed_point_on_the_card_matches_the_cpu(cuda_device):
    """frexp, the shifts and the float32 sum over limbs give the same bits
    on the card, subnormals, zeros, inf/NaN and 1e-12..1e20 included."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, np.inf, -np.inf,
                  np.nan, 2.0 ** -40, -2.0 ** 87, 3.4028235e38], np.float32),
        (rng.choice([-1.0, 1.0], 20000)
         * 10.0 ** rng.uniform(-12, 20, 20000)).astype(np.float32)])
    cpu = torch.from_numpy(x)
    for frac_bits in (40, 60, 0):
        fixed = f32_to_fixed(cpu, frac_bits=frac_bits)
        got = f32_to_fixed(cpu.to(cuda_device), frac_bits=frac_bits)
        assert torch.equal(got.cpu(), fixed)
        back = fixed_to_f32(got, frac_bits=frac_bits)
        assert torch.equal(back.cpu().view(torch.int32),
                           fixed_to_f32(fixed, frac_bits=frac_bits)
                           .view(torch.int32))
    stacked = cpu[:20000].reshape(100, 200)
    assert torch.equal(exact_sum(stacked.to(cuda_device), 0).cpu()
                       .view(torch.int32),
                       exact_sum(stacked, 0).view(torch.int32))


def test_collectives_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """A one-rank gloo world: exact_psum is exact_sum of one, and
    compressed_psum gives the CPU's bits for CUDA tensors."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        gen = torch.Generator().manual_seed(4)
        x = torch.randn((64, 1000), generator=gen)
        got = exact_psum(x.to(cuda_device))
        assert got.device == cuda_device
        assert torch.equal(got.cpu().view(torch.int32),
                           exact_sum(x[None], 0).view(torch.int32))
        grads = {"w": x, "b": x[0]}
        want = compressed_psum(grads, init_error(grads))
        card = {k: v.to(cuda_device) for k, v in grads.items()}
        out = compressed_psum(card, init_error(card))
        for got_tree, want_tree in zip(out, want):
            for k in grads:
                assert got_tree[k].device == cuda_device
                assert torch.equal(got_tree[k].cpu().view(torch.int32),
                                   want_tree[k].view(torch.int32))
    finally:
        dist.destroy_process_group()


def test_rng_and_sources_on_the_card_match_the_cpu(cuda_device, tmp_path):
    offs = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 3,
                         123_456_789])
    got = random_u32(9, 1, offs.to(cuda_device))
    assert got.device == cuda_device
    assert torch.equal(got.cpu(), random_u32(9, 1, offs))
    known = philox4x32(torch.zeros((1, 4), dtype=torch.int64,
                                   device=cuda_device),
                       torch.zeros((1, 2), dtype=torch.int64,
                                   device=cuda_device))
    assert known[0].tolist() == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                 0x9B00DBD8]
    path = tmp_path / "corpus.bin"
    np.arange(5000, dtype=np.uint16).tofile(path)
    for source in ("synthetic", "pattern", "binfile"):
        cfg = data.DataConfig(vocab_size=1000, seq_len=16, global_batch=8,
                              seed=5, source=source, path=str(path))
        got = data.make_source(cfg).batch_at(4)
        want = data.make_source(cfg, device="cpu").batch_at(4)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        on_card = data.device_batch(got)
        assert all(v.device == cuda_device for v in on_card.values())
