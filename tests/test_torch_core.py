"""PyTorch ``core.mcim`` held against the JAX reference over the verifier's
vocabulary: Star, FB/FF x CT{2,3,4,6,8,12} (CT > LB included),
Karatsuba K1-K3 x 1CA/3CA and signed variants, at widths 8-128.

Every case feeds the same numpy operands to ``repro.core.mcim.mcim_mul``
(jitted, on the CPU) and ``repro_torch.core.mcim.mcim_mul`` and requires
integer equality (tolerance 0) with each other and with the
Python-bigint oracle.
"""
import functools

import numpy as np
import pytest
import torch
import jax

from repro.core import limbs as RL
from repro.core import mcim as RM
from repro_torch.core import limbs as TL
from repro_torch.core import mcim as TM

WIDTHS = (8, 16, 32, 64, 128)
FOLD_CTS = (2, 3, 4, 6, 8, 12)
BATCH = 8


def _oracle(a, b, bits_a, bits_b, signed):
    la, lb = a.shape[-1], b.shape[-1]
    mod = 1 << (16 * (la + lb))
    out = []
    for x, y in zip(a, b):
        x, y = RL.from_limbs(x), RL.from_limbs(y)
        if signed:       # two's complement of the limb width
            x -= (x >> (16 * la - 1)) << (16 * la)
            y -= (y >> (16 * lb - 1)) << (16 * lb)
        out.append((x * y) % mod)
    return out


def _check(arch, ct, bits, *, levels=1, adder="1ca", signed=False, seed=0):
    kw = dict(arch=arch, ct=ct, levels=levels, adder=adder, signed=signed)
    rng = np.random.default_rng(seed * 1009 + bits)
    a = RL.random_limbs(rng, (BATCH,), bits)
    b = RL.random_limbs(rng, (BATCH,), bits)
    ref = jax.jit(functools.partial(RM.mcim_mul,
                                    config=RM.MCIMConfig(**kw)))(a, b)
    port = TM.mcim_mul(TL.from_numpy(a, "cpu"), TL.from_numpy(b, "cpu"),
                       TM.MCIMConfig(**kw))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(ref).astype(np.int32))
    assert TL.batch_from_limbs(port) == _oracle(a, b, bits, bits, signed)


@pytest.mark.parametrize("bits", WIDTHS)
def test_star_matches_reference(bits):
    _check("star", 1, bits)


@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("ct", FOLD_CTS)
@pytest.mark.parametrize("arch", ("fb", "ff"))
def test_folded_schoolbook_matches_reference(arch, ct, bits):
    _check(arch, ct, bits, seed=ct)


@pytest.mark.parametrize("bits", (16, 64, 128))
@pytest.mark.parametrize("adder", ("1ca", "3ca"))
@pytest.mark.parametrize("levels", (1, 2, 3))
def test_karatsuba_matches_reference(levels, adder, bits):
    _check("karatsuba", 3, bits, levels=levels, adder=adder, seed=levels)


@pytest.mark.parametrize("bits", (16, 64))
@pytest.mark.parametrize("arch,ct,levels,adder", [
    ("star", 1, 1, "1ca"), ("fb", 3, 1, "1ca"), ("ff", 2, 1, "1ca"),
    ("ff", 4, 1, "3ca"), ("karatsuba", 3, 2, "3ca")])
def test_signed_matches_reference(arch, ct, levels, adder, bits):
    _check(arch, ct, bits, levels=levels, adder=adder, signed=True, seed=7)


def test_mul32x32_64_matches_reference():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 32, size=64, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=64, dtype=np.uint64)
    a[:2], b[:2] = (1 << 32) - 1, (1 << 32) - 1      # the carry extremes
    lo_r, hi_r = RM.mul32x32_64(a.astype(np.uint32), b.astype(np.uint32))
    lo_p, hi_p = TM.mul32x32_64(torch.from_numpy(a.astype(np.int64)),
                                torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_r))
    np.testing.assert_array_equal(hi_p.numpy(), np.asarray(hi_r))
    full = a.astype(object) * b.astype(object)
    assert [int(h) << 32 | int(lo) for lo, h in zip(lo_p, hi_p)] == \
        [int(x) for x in full]


def test_make_multiplier_checks_widths():
    mul = TM.make_multiplier(32, 32, arch="fb", ct=2)
    a = TL.from_numpy(TL.to_limbs(0xDEADBEEF, 2)[None], "cpu")
    assert TL.from_limbs(mul(a, a)[0]) == 0xDEADBEEF ** 2
    with pytest.raises(ValueError):
        mul(a[:, :1], a)


def test_config_validation_matches_reference():
    for kw in (dict(arch="star", ct=2), dict(arch="karatsuba", ct=2),
               dict(arch="ff", ct=2, adder="3ca"), dict(arch="nope")):
        with pytest.raises(ValueError):
            RM.MCIMConfig(**kw)
        with pytest.raises(ValueError):
            TM.MCIMConfig(**kw)
