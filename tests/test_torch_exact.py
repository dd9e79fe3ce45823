"""The port's ``exact`` (fixed-point deterministic sums) against the JAX
reference's ``repro.exact``, on the CPU.

Every comparison is bit for bit: limbs as integers, float32 results as
their uint32 bit patterns.  Inputs are seeded numpy arrays that cover
signs, zeros, subnormals, inf/NaN (encoded as 0) and magnitudes from
1e-12 to 1e20, beyond the 2^87 integer headroom.  The order-invariance
property is the reference's hypothesis test (``tests/test_substrate.py``)
run on the port.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.exact import fixedpoint as RF
from repro_torch import exact as TE
from repro_torch.exact import fixedpoint as TF

SPECIAL = np.array(
    [0.0, -0.0, 1.0, -1.0, 3.14159, -2.5e-7, 1e6, np.inf, -np.inf, np.nan,
     1e-45, -1e-45, 1.1754942e-38, -1.1754942e-38, 3.4028235e38,
     -3.4028235e38, 2.0 ** -40, -2.0 ** -40, 2.0 ** -41, -2.0 ** -41,
     2.0 ** -40 * 1.5, 2.0 ** 86, -2.0 ** 87, 2.0 ** 87, 2.0 ** 88,
     -2.0 ** 100, 65535.0, -65536.0, 16777215.0, -16777217.0],
    np.float32)


def _values(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(-12, 20, n)
    signs = rng.choice([-1.0, 1.0], n)
    return np.concatenate([SPECIAL, (signs * mags).astype(np.float32),
                           rng.standard_normal(n).astype(np.float32)])


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _ref_to_fixed(x, **kw):
    return np.asarray(RF.f32_to_fixed(jnp.asarray(x), **kw)).astype(np.int64)


@pytest.mark.parametrize("frac_bits,n_limbs", [(40, 8), (40, 4), (24, 8),
                                               (0, 8), (60, 6)])
@pytest.mark.parametrize("seed", (0, 1))
def test_f32_to_fixed_matches_reference(seed, frac_bits, n_limbs):
    x = _values(seed, 2000)
    want = _ref_to_fixed(x, frac_bits=frac_bits, n_limbs=n_limbs)
    got = TF.f32_to_fixed(torch.from_numpy(x), frac_bits=frac_bits,
                          n_limbs=n_limbs)
    assert got.dtype == torch.int32
    assert got.shape == x.shape + (n_limbs,)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("frac_bits,n_limbs", [(40, 8), (24, 8), (60, 6)])
def test_fixed_to_f32_matches_reference_on_encodings(frac_bits, n_limbs):
    x = _values(2, 2000)[:3999].reshape(-1, 3)
    fixed = _ref_to_fixed(x, frac_bits=frac_bits, n_limbs=n_limbs)
    want = RF.fixed_to_f32(jnp.asarray(fixed.astype(np.uint32)),
                           frac_bits=frac_bits)
    got = TF.fixed_to_f32(torch.from_numpy(fixed), frac_bits=frac_bits)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n_terms", (2, 100, 65535))
def test_fixed_to_f32_matches_reference_on_column_sums(n_terms):
    """Carry-save column sums of up to 2^16 - 1 encodings, each column
    below 2^32, both signs: the float32 sum over limbs is taken in the
    reference's order (lowest limb first)."""
    rng = np.random.default_rng(n_terms)
    cols = rng.integers(0, n_terms * 0xFFFF + 1, size=(4000, 8),
                        dtype=np.int64)
    want = RF.fixed_to_f32(jnp.asarray(cols.astype(np.uint32)))
    got = TF.fixed_to_f32(torch.from_numpy(cols))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert np.array_equal(np.isnan(got.numpy()), np.zeros(4000, bool))


def test_roundtrip_as_the_reference_checks_it():
    x = np.array([0.0, 1.0, -1.0, 3.14159, -2.5e-7, 1e6], np.float32)
    back = TF.fixed_to_f32(TF.f32_to_fixed(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-6, atol=2e-12)


@pytest.mark.parametrize("shape,axis", [((64,), 0), ((50, 7), 0),
                                        ((50, 7), 1), ((3, 40, 5), 1),
                                        ((3, 40, 5), 2), ((1000,), 0)])
def test_exact_sum_matches_reference(shape, axis):
    rng = np.random.default_rng(sum(shape) + axis)
    x = (rng.standard_normal(shape)
         * 10.0 ** rng.uniform(-6, 6, shape)).astype(np.float32)
    x.flat[::17] = 0.0
    want = RF.exact_sum(jnp.asarray(x), axis=axis)
    got = TE.exact_sum(torch.from_numpy(x), axis=axis)
    assert got.shape == tuple(np.asarray(want).shape)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_exact_sum_wraps_columns_as_uint32():
    """70,000 copies of -1.0, past the 2^16 terms a uint32 column holds:
    the reference's column sums wrap mod 2^32, and the port's int64
    sums are masked to the same bits."""
    x = np.full((70_000,), -1.0, np.float32)
    want = RF.exact_sum(jnp.asarray(x))
    got = TE.exact_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fixed_add_matches_reference():
    x = _values(3, 500)
    a, b = _ref_to_fixed(x[:500]), _ref_to_fixed(x[500:1000])
    want = np.asarray(RF.fixed_add(jnp.asarray(a.astype(np.uint32)),
                                   jnp.asarray(b.astype(np.uint32))))
    got = TF.fixed_add(torch.from_numpy(a).int(), torch.from_numpy(b).int())
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        TF.fixed_to_f32(got).numpy().view(np.uint32),
        _bits(RF.fixed_to_f32(jnp.asarray(want))))


def test_exact_tree_sum_matches_reference():
    rng = np.random.default_rng(4)
    trees = [{"a": rng.standard_normal((4, 4)).astype(np.float32),
              "b": [rng.standard_normal(3).astype(np.float32)]}
             for _ in range(8)]
    want = RF.exact_tree_sum([{"a": jnp.asarray(t["a"]),
                               "b": [jnp.asarray(t["b"][0])]}
                              for t in trees])
    got = TE.exact_tree_sum([{"a": torch.from_numpy(t["a"]),
                              "b": [torch.from_numpy(t["b"][0])]}
                             for t in trees])
    np.testing.assert_array_equal(_bits(got["a"].numpy()),
                                  _bits(want["a"]))
    np.testing.assert_array_equal(_bits(got["b"][0].numpy()),
                                  _bits(want["b"][0]))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False, width=32),
                min_size=2, max_size=50))
def test_exact_sum_order_invariant(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    s1 = float(TE.exact_sum(x))
    perm = np.array(vals, np.float32)
    rng = np.random.default_rng(0)
    for _ in range(4):
        rng.shuffle(perm)
        s2 = float(TE.exact_sum(torch.from_numpy(perm)))
        assert s1 == s2            # BIT-exact, not approx


def test_negative_axis_counts_the_axes_of_x():
    """The port reads a negative axis against ``x``; the reference passes
    it on to the limb-extended encoding, so only non-negative axes are
    compared with it above."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (5, 6, 7)).astype(np.float32))
    for axis in (-1, -2, -3):
        assert torch.equal(TE.exact_sum(x, axis=axis),
                           TE.exact_sum(x, axis=axis + 3))
