"""PyTorch port of core/limbs held against the JAX reference, bit for bit.

The same numpy operands (the reference's ``random_limbs`` on a seeded
generator) go through ``repro.core.limbs`` and ``repro_torch.core.limbs``;
every result must be equal as integers (tolerance 0) and agree with the
Python-bigint oracle.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import limbs as RL
from repro_torch.core import limbs as TL

WIDTHS = (8, 16, 32, 64, 128, 256)
BATCH = 16


def _ops(seed, bits_a, bits_b=None):
    rng = np.random.default_rng(seed)
    a = RL.random_limbs(rng, (BATCH,), bits_a)
    b = RL.random_limbs(rng, (BATCH,), bits_b or bits_a)
    return a, b


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


def _t(x):
    return TL.from_numpy(x, "cpu")


def _value(cols_row):
    return TL.from_limbs(np.asarray(cols_row).astype(np.int64))


def test_random_limbs_draws_the_reference_stream():
    a = RL.random_limbs(np.random.default_rng(3), (4, 5), 37)
    b = TL.random_limbs(np.random.default_rng(3), (4, 5), 37)
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.uint32 and int(b[..., -1].max()) < 1 << 5


@pytest.mark.parametrize("bits", WIDTHS)
def test_to_from_limbs_roundtrip(bits):
    rng = np.random.default_rng(bits)
    vals = [int(rng.integers(0, 1 << min(bits, 62))) << max(bits - 62, 0)
            for _ in range(BATCH)]
    n = TL.n_limbs_for_bits(bits)
    assert n == RL.n_limbs_for_bits(bits)
    port = TL.batch_to_limbs(vals, n)
    np.testing.assert_array_equal(port, RL.batch_to_limbs(vals, n))
    assert TL.batch_from_limbs(torch.from_numpy(port.astype(np.int32))) \
        == vals == RL.batch_from_limbs(port)
    with pytest.raises(ValueError):
        TL.to_limbs(1 << (16 * n), n)
    with pytest.raises(ValueError):
        TL.to_limbs(-1, n)


@pytest.mark.parametrize("bits", WIDTHS)
def test_ppm_matches_reference(bits):
    a, b = _ops(bits, bits, max(8, bits // 2))
    port = TL.ppm(_t(a), _t(b))
    assert port.dtype == torch.int64
    _same(port, RL.ppm(jnp.asarray(a), jnp.asarray(b)))
    for row, x, y in zip(port, a, b):
        assert _value(row) == RL.from_limbs(x) * RL.from_limbs(y)


@pytest.mark.parametrize("bits", WIDTHS)
def test_compress_and_negate_match_reference(bits):
    a, b = _ops(bits + 1, bits)
    n = a.shape[-1]
    width = 2 * n + 1
    terms_ref = [(RL.ppm(jnp.asarray(a), jnp.asarray(b)), 0),
                 (jnp.asarray(a), n), (jnp.asarray(b), n + 1)]
    terms_port = [(TL.ppm(_t(a), _t(b)), 0), (_t(a), n), (_t(b), n + 1)]
    _same(TL.compress(terms_port, width), RL.compress(terms_ref, width))
    for shift in (0, 1, n):
        inv_p, one_p = TL.negate_cols(_t(a), shift, width)
        inv_r, one_r = RL.negate_cols(jnp.asarray(a), shift, width)
        _same(inv_p, inv_r)
        _same(one_p, one_r)
        # NOT+1 is -(a << 16*shift) mod 2**(16*width)
        for row_i, row_o, x in zip(inv_p, one_p, a):
            got = (_value(row_i) + _value(row_o)) % (1 << (16 * width))
            assert got == -(RL.from_limbs(x) << (16 * shift)) \
                % (1 << (16 * width))


@pytest.mark.parametrize("adder", ("1ca", "3ca"))
@pytest.mark.parametrize("bits", WIDTHS)
def test_final_adders_truncate_and_pad(bits, adder):
    a, b = _ops(bits + 2, bits)
    cols_ref = RL.compress([(RL.ppm(jnp.asarray(a), jnp.asarray(b)), 0),
                            (jnp.asarray(a), 0)], 2 * a.shape[-1] + 1)
    cols_port = TL.compress([(TL.ppm(_t(a), _t(b)), 0), (_t(a), 0)],
                            2 * a.shape[-1] + 1)
    width = cols_port.shape[-1]
    for out_limbs in (None, 1, width + 3):       # as-is, truncate, pad
        port = TL.FINAL_ADDERS[adder](cols_port, out_limbs)
        ref = RL.FINAL_ADDERS[adder](cols_ref, out_limbs)
        assert port.dtype == torch.int32
        _same(port, ref)
        keep = width if out_limbs is None else out_limbs
        for row, x, y in zip(port, a, b):
            exact = RL.from_limbs(x) * RL.from_limbs(y) + RL.from_limbs(x)
            assert TL.from_limbs(row) == exact % (1 << (16 * keep))


@pytest.mark.parametrize("bits", WIDTHS)
def test_add_canonical_and_pad_limbs(bits):
    a, b = _ops(bits + 3, bits, max(8, bits - 16))
    n = a.shape[-1] + 1
    port = TL.add_canonical(_t(a), _t(b), n)
    _same(port, RL.add_canonical(jnp.asarray(a), jnp.asarray(b), n))
    assert TL.batch_from_limbs(port) == [
        RL.from_limbs(x) + RL.from_limbs(y) for x, y in zip(a, b)]
    _same(TL.pad_limbs(_t(b), n), RL.pad_limbs(jnp.asarray(b), n))
    with pytest.raises(ValueError):
        TL.pad_limbs(_t(a), a.shape[-1] - 1)


def test_from_numpy_rejects_non_canonical_limbs():
    with pytest.raises(ValueError):
        TL.from_numpy(np.array([1 << 16], np.uint32), "cpu")
    t = TL.from_numpy(np.array([0xFFFF, 7], np.uint32), "cpu")
    assert t.dtype == torch.int32 and t.tolist() == [0xFFFF, 7]
