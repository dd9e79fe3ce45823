"""The serving path on the card: the fused bank at every serving bucket,
and ``CompiledDesign.serve`` on the card equal to the same call on the
CPU.

A serving round is a bucket of 1, 2, 4, ... rows, not a million: some
instances get no rows and an instance's rows may be fewer than a tile,
so the bank kernel's path choice (``kernels/_row_tiles.py`` ``plan``)
and its bulk tiles are held bit for bit against the plain core bank at
every bucket.  Every test here needs a CUDA card (marker ``cuda``) and
skips without one; nothing imports jax, so ``python -m pytest -m cuda
tests/test_torch_serving_cuda.py`` runs on a machine without it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import designs, serving
from repro_torch.core import limbs as L
from repro_torch.core.bank import Bank
from repro_torch.kernels import launch_counts

pytestmark = pytest.mark.cuda

BUCKETS = tuple(1 << k for k in range(9))          # 1 .. 256
POINTS = ("tbl8_w32_relaxed", "tp3p5_w32", "tp5over6_w128")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (the CPU path is their plain version)")
    return torch.device("cuda", torch.cuda.current_device())


def _oracle(a, b):
    return [L.from_limbs(x) * L.from_limbs(y) for x, y in zip(a, b)]


@pytest.mark.parametrize("name", designs.names())
def test_fused_bank_every_bucket_bit_exact(name, cuda_device):
    d = designs.generate(name, device=cuda_device)
    assert d.bank.backend == "fused"
    plain = Bank(d.plan, d.spec.bits_a, d.spec.bits_b, backend="core",
                 device=cuda_device)
    rng = np.random.default_rng(len(name))
    for batch in BUCKETS:
        a = L.random_limbs(rng, (batch,), d.spec.bits_a)
        b = L.random_limbs(rng, (batch,), d.spec.bits_b)
        ta, tb = L.from_numpy(a, cuda_device), L.from_numpy(b, cuda_device)
        before = launch_counts()["bank_fold"]
        out = d.bank.execute(ta, tb)
        torch.cuda.synchronize()
        assert launch_counts()["bank_fold"] - before == 1, batch
        assert torch.equal(out, plain.execute(ta, tb)), batch
        assert L.batch_from_limbs(out) == _oracle(a, b), batch


def _report(rep):
    d = dataclasses.asdict(rep)
    d.pop("wall_s")
    return d


def _serve_both(spec, n, load, seed, **kw):
    card = designs.generate(spec)
    cpu = designs.generate(spec, device="cpu")
    tp = float(card.plan.throughput)
    arr = serving.poisson_arrivals(n, load * tp, seed=seed)
    reqs = serving.synthesize(arr, card.spec.bits_a, card.spec.bits_b,
                              budget=max(8, int(32 / tp)), seed=seed + 1)
    got = card.serve(reqs, check=True, **kw)
    want = cpu.serve(reqs, check=True, **kw)
    return card, got, want


@pytest.mark.parametrize("name", POINTS)
def test_serve_on_card_equals_cpu(name, cuda_device):
    card, (rep, resp), (c_rep, c_resp) = _serve_both(name, 256, 0.9, 7,
                                                    replicas=2)
    assert card.bank.backend == "fused"
    assert resp == c_resp
    assert _report(rep) == _report(c_rep)
    assert rep.bit_exact is True


def test_signed_serve_on_card_equals_cpu(cuda_device):
    spec = dataclasses.replace(designs.get("tp3p5_w32"), signed=True)
    card, (rep, resp), (c_rep, c_resp) = _serve_both(spec, 256, 0.9, 9,
                                                    replicas=2)
    assert card.bank.backend == "fused"
    assert resp == c_resp
    assert _report(rep) == _report(c_rep)
    assert rep.bit_exact is True


def test_serve_on_card_launches_once_a_round(cuda_device):
    d = designs.generate("tp3p5_w32")
    tp = float(d.plan.throughput)
    reqs = serving.synthesize(serving.poisson_arrivals(128, 0.7 * tp, 3),
                              32, 32, budget=64, seed=4)
    before = launch_counts()["bank_fold"]
    rep, _ = d.serve(reqs, replicas=2, check=True)
    assert launch_counts()["bank_fold"] - before == rep.rounds
    assert rep.bit_exact is True
