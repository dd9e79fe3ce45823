"""The port's spatial Karatsuba multiply (kernel #6) against the JAX
reference, bit for bit.

The same seeded numpy operands go through the reference's Pallas kernel
in interpret mode (``repro.kernels.karatsuba_ppm.karatsuba_ppm_mul``)
and the port's wrapper on the CPU (its plain version, the core
one-level Karatsuba); limbs must be equal as integers (tolerance 0) and
equal the Python-bigint product.  Sizes are the reference tests' own
(``tests/test_kernels_extra.py``).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.core import limbs as RL
from repro.kernels import karatsuba_ppm as RK
from repro_torch.core import limbs as TL
from repro_torch.kernels import _build
from repro_torch.kernels import karatsuba_ppm as TK


def _port(a, b, **kwargs):
    before = _build.launch_counts()
    out = TK.kara_mul(TL.from_numpy(a, "cpu"), TL.from_numpy(b, "cpu"),
                      **kwargs)
    assert _build.launch_counts() == before      # CPU: no kernel launch
    assert out.dtype == TL.LIMB_DTYPE
    return out.numpy()


@pytest.mark.parametrize("bits", [32, 64, 128, 256])
def test_kara_matches_reference_kernel(bits):
    rng = np.random.default_rng(bits)
    a = RL.random_limbs(rng, (32,), bits)
    b = RL.random_limbs(rng, (32,), bits)
    want = np.asarray(RK.karatsuba_ppm_mul(jnp.asarray(a), jnp.asarray(b),
                                           tile_b=16, interpret=True))
    got = _port(a, b)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    np.testing.assert_array_equal(_port(a, b, use_kernel=False), got)
    assert TL.batch_from_limbs(got) == [
        TL.from_limbs(x) * TL.from_limbs(y) for x, y in zip(a, b)]


@pytest.mark.parametrize("n", [2, 6, 10, 12, 14])
def test_kara_other_even_widths(n):
    """Every even width the CUDA kernel is built for (2..16 limbs)."""
    rng = np.random.default_rng(n)
    a = RL.random_limbs(rng, (16,), 16 * n)
    b = RL.random_limbs(rng, (16,), 16 * n)
    a[0], b[0] = RL.MASK, RL.MASK                 # all-ones operands
    want = np.asarray(RK.karatsuba_ppm_mul(jnp.asarray(a), jnp.asarray(b),
                                           tile_b=8, interpret=True))
    np.testing.assert_array_equal(_port(a, b), want.astype(np.int32))


def test_kara_edge_values():
    vals = [0, 1, 2**64 - 1, 2**63, 0xFFFF0000FFFF0000]
    a = RL.batch_to_limbs(vals, 4)
    b = RL.batch_to_limbs(list(reversed(vals)), 4)
    want = np.asarray(RK.kara_mul(jnp.asarray(a), jnp.asarray(b)))
    got = _port(a, b)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    for va, vb, row in zip(vals, reversed(vals), got):
        assert TL.from_limbs(row) == va * vb


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**128 - 1), st.integers(0, 2**128 - 1))
def test_kara_property(x, y):
    a, b = RL.to_limbs(x, 8)[None], RL.to_limbs(y, 8)[None]
    want = np.asarray(RK.karatsuba_ppm_mul(jnp.asarray(a), jnp.asarray(b),
                                           tile_b=1, interpret=True))
    got = _port(a, b)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    assert TL.from_limbs(got[0]) == x * y


def test_kara_tile_does_not_change_the_result():
    rng = np.random.default_rng(5)
    a, b = (TL.from_numpy(RL.random_limbs(rng, (8,), 128), "cpu")
            for _ in range(2))
    assert torch.equal(TK.karatsuba_ppm_mul(a, b, tile_b=1),
                       TK.karatsuba_ppm_mul(a, b, tile_b=256))


def test_kara_shape_errors():
    odd = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):               # even N, as the reference
        TK.karatsuba_ppm_mul(odd, odd)
    even = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        TK.karatsuba_ppm_mul(even, even[:2])
    with pytest.raises(ValueError):
        TK.karatsuba_ppm_mul(even, even, tile_b=0)
