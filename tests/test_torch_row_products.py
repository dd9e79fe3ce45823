"""The row arithmetic of the FB and both Karatsuba kernels, modelled in
torch int64 and held against the reference.

``csrc/mcim_fold.cu`` multiplies FB's rows (and FF's) by one schoolbook
pass, every B limb at weight 1 (``ct_run * chunk >= LB`` at every
geometry), and one carry pass truncated to LA+LB, where the reference's
FB runs a 1CA every cycle (``ExactRows``).  ``csrc/karatsuba_ppm.cu`` computes T0, T1
and T2 as exact products (whole limb products in 64-bit column sums)
and places them on 2N uint32 columns that start at the complements'
2*MASK (``KaraRows``, ``csrc/kara_rows.cuh``); the folded Karatsuba of
``csrc/mcim_fold.cu`` runs the same functor on rows zero-filled to
N = max(LA, LB) rounded up to even and carries LA+LB columns.  The
models below repeat that arithmetic step for step, check the column
bounds the CUDA code relies on (uint32 column sums that never wrap),
and must give the reference's bits exactly (tolerance 0) on random and
all-0xFFFF limbs (the largest columns): FB and the folded Karatsuba
against the port's plain versions at every geometry and against the JAX
reference's at a sample of them, the spatial Karatsuba against the
reference's Pallas kernel (interpret mode).  The JAX reference is
imported inside the tests that use it (the ``ref`` fixture), so that
``pytest -m cuda`` collects this file on a machine without jax.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import limbs as TL
from repro_torch.kernels import mcim_fold as TF

MASK = TL.MASK
U32 = 1 << 32


@pytest.fixture
def ref():
    """The JAX reference's modules (imported here, not at module level)."""
    import jax.numpy as jnp
    from repro.core import schoolbook
    from repro.kernels import karatsuba_ppm, mcim_fold
    return types.SimpleNamespace(jnp=jnp, schoolbook=schoolbook,
                                 karatsuba_ppm=karatsuba_ppm,
                                 mcim_fold=mcim_fold)


def _operands(seed, rows, la, lb):
    """Random (rows, LA) x (rows, LB) limbs, the first two rows all
    0xFFFF, as int64 tensors."""
    rng = np.random.default_rng(seed)
    a = TL.random_limbs(rng, (rows,), 16 * la)
    b = TL.random_limbs(rng, (rows,), 16 * lb)
    a[:2], b[:2] = MASK, MASK
    return (torch.from_numpy(a.astype(np.int64)),
            torch.from_numpy(b.astype(np.int64)))


def _carry(cols, n):
    """One carry pass over int64 column sums, truncated to n limbs."""
    out, carry = [], torch.zeros_like(cols[:, 0])
    for k in range(n):
        tot = (cols[:, k] if k < cols.shape[1] else 0) + carry
        out.append(tot & MASK)
        carry = tot >> 16
    return torch.stack(out, dim=1)


def fb_rows_model(a, b, ct):
    """``ExactRows`` + ``tiles::schoolbook``: every B limb at weight 1,
    since FB's cycles take every limb below ``ct_run * chunk``, which
    covers LB; lo and hi halves of each 16x16 product on uint32 columns,
    one carry pass truncated to LA+LB."""
    la, lb = a.shape[1], b.shape[1]
    geo = TF.fold_geometry(la, lb, ct, "fb")
    assert geo.ct_run * geo.chunk >= lb           # no B limb left out
    cols = torch.zeros((a.shape[0], la + lb), dtype=torch.int64)
    for jb in range(lb):
        p = a * b[:, jb:jb + 1]                   # A x B limb jb, exact
        cols[:, jb:jb + la] += p & MASK
        cols[:, jb + 1:jb + la + 1] += p >> 16
    assert int(cols.max()) < U32                  # no uint32 column wraps
    return _carry(cols, la + lb)


def _exact(x, y):
    """``exact_product``: limb products whole into 64-bit column sums
    (each below L * 2**32), one carry pass to 2L limbs."""
    n = x.shape[1]
    cols = torch.zeros((x.shape[0], 2 * n - 1), dtype=torch.int64)
    for j in range(n):
        for i in range(n):
            cols[:, i + j] += x[:, i] * y[:, j]
    assert int(cols.max()) < n * U32
    t = _carry(cols, 2 * n)
    assert int(t[:, -1].max()) <= MASK            # the product fits 2L
    return t


def kara_rows_model(a, b):
    """``KaraRows::product`` for rows of N limbs, N even: the complements'
    2*MASK columns (+2 in column 0), T0 and T1 placed as computed, the
    carried half sums' product T2 last, one carry pass mod 2**(32N)."""
    n = a.shape[1]
    h, w = n // 2, 2 * n
    take2 = min(2 * h + 2, w - h)
    acc = torch.full((a.shape[0], w), 2 * MASK, dtype=torch.int64)
    acc[:, 0] += 2
    t0 = _exact(a[:, :h], b[:, :h])
    acc[:, :2 * h] += t0
    acc[:, h:3 * h] -= t0
    t1 = _exact(a[:, h:], b[:, h:])
    acc[:, 2 * h:] += t1
    acc[:, h:3 * h] -= t1
    sa = _carry(a[:, :h] + a[:, h:], h + 1)
    sb = _carry(b[:, :h] + b[:, h:], h + 1)
    acc[:, h:h + take2] += _exact(sa, sb)[:, :take2]
    # each column's value fits a uint32 (the sums mod 2**32 give it)
    assert int(acc.min()) >= 0 and int(acc.max()) < U32
    return _carry(acc, w)


def kara_fold_rows_model(a, b):
    """The folded Karatsuba's kernel: both operands zero-filled to N =
    max(LA, LB) rounded up to even, ``kara_rows_model``, and the carry
    pass kept to LA+LB columns (the product mod 2**(16 (LA+LB)), which is
    the product itself)."""
    la, lb = a.shape[1], b.shape[1]
    n = max(la, lb) + max(la, lb) % 2
    a = torch.nn.functional.pad(a, (0, n - la))
    b = torch.nn.functional.pad(b, (0, n - lb))
    return kara_rows_model(a, b)[:, :la + lb]


def _bigint(a, b):
    return [TL.from_limbs(x) * TL.from_limbs(y)
            for x, y in zip(a.numpy(), b.numpy())]


@pytest.mark.parametrize("lb", range(1, 17))
def test_fb_rows_model_is_feedback_mul_bit_for_bit(lb, ref):
    """Every (LA, LB <= 16, CT = 1 .. LB + 2): CT > LB folds only LB
    limbs.  The port's plain FB, and the JAX reference's at CT = 1, 2,
    LB + 2 for one LA a width."""
    for la in range(1, 17):
        a, b = _operands(100 * la + lb, 6, la, lb)
        want = _bigint(a, b)
        a32, b32 = a.to(torch.int32), b.to(torch.int32)
        ref_ct = (1, 2, lb + 2) if la == lb * 7 % 16 + 1 else ()
        for ct in range(1, lb + 3):
            got = fb_rows_model(a, b, ct)
            assert TL.batch_from_limbs(got) == want
            plain = TF.mcim_fold_mul_ref(a32, b32, ct=ct, schedule="fb")
            assert torch.equal(got.to(torch.int32), plain)
            if ct in ref_ct:
                ja, jb = (ref.jnp.asarray(x.numpy().astype(np.uint32))
                          for x in (a, b))
                jref = (ref.schoolbook.star_mul(ja, jb) if ct == 1
                        else ref.schoolbook.feedback_mul(ja, jb, ct=ct))
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(jref).astype(np.int64))


@pytest.mark.parametrize("n", (2, 4, 6, 8, 10, 12, 14, 16))
def test_kara_rows_model_is_the_reference_kernel_bit_for_bit(n, ref):
    a, b = _operands(n, 16, n, n)
    want = ref.karatsuba_ppm.karatsuba_ppm_mul(
        ref.jnp.asarray(a.numpy().astype(np.uint32)),
        ref.jnp.asarray(b.numpy().astype(np.uint32)), tile_b=8,
        interpret=True)
    got = kara_rows_model(a, b)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    assert TL.batch_from_limbs(got) == _bigint(a, b)


@pytest.mark.parametrize("lb", range(1, 17))
def test_kara_fold_rows_model_is_the_folded_karatsuba_bit_for_bit(lb,
                                                                   ref):
    """Every (LA, LB <= 16) against the port's plain folded Karatsuba and
    the bigint oracle; the JAX reference's ``_kara_kernel`` (interpret
    mode) at one LA a width."""
    for la in range(1, 17):
        a, b = _operands(1000 + 100 * la + lb, 6, la, lb)
        got = kara_fold_rows_model(a, b)
        assert TL.batch_from_limbs(got) == _bigint(a, b)
        plain = TF.mcim_fold_mul_ref(a.to(torch.int32), b.to(torch.int32),
                                     ct=3, schedule="karatsuba")
        assert torch.equal(got.to(torch.int32), plain)
        if la == lb * 7 % 16 + 1:
            want = ref.mcim_fold.mcim_fold_mul(
                ref.jnp.asarray(a.numpy().astype(np.uint32)),
                ref.jnp.asarray(b.numpy().astype(np.uint32)), ct=3,
                schedule="karatsuba", interpret=True)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want).astype(np.int64))
