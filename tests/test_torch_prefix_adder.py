"""The port's parallel-prefix final adder (kernel #5) against the JAX
reference, bit for bit.

The same seeded numpy columns go through the reference's Pallas kernel
in interpret mode (``repro.kernels.prefix_adder.prefix_final_adder``)
and the port's wrapper on the CPU (its plain version); limbs must be
equal as integers (tolerance 0).  Sizes are the reference tests' own
(``tests/test_kernels_extra.py``).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.core import limbs as RL
from repro.kernels import prefix_adder as RP
from repro_torch.core import limbs as TL
from repro_torch.kernels import _build
from repro_torch.kernels import prefix_adder as TP


def _port(cols, **kwargs):
    """The port's adder on the CPU, asserting no kernel was launched."""
    before = _build.launch_counts()
    out = TP.fast_final_adder(torch.from_numpy(cols.astype(np.int64)),
                              **kwargs)
    assert _build.launch_counts() == before
    assert out.dtype == TL.LIMB_DTYPE
    return out.numpy()


@pytest.mark.parametrize("width", [4, 8, 17, 32, 64])
def test_prefix_adder_matches_reference_kernel(width):
    rng = np.random.default_rng(width)
    cols = rng.integers(0, 2**24, (64, width), dtype=np.uint32)
    want = np.asarray(RP.prefix_final_adder(jnp.asarray(cols), tile_b=32,
                                            interpret=True))
    np.testing.assert_array_equal(_port(cols), want.astype(np.int32))
    np.testing.assert_array_equal(
        _port(cols, use_kernel=False),
        np.asarray(RP.prefix_final_adder_ref(jnp.asarray(cols))))


@pytest.mark.parametrize("tile_b", [1, 8, 256])
def test_prefix_adder_tile_does_not_change_the_result(tile_b):
    rng = np.random.default_rng(3)
    cols = torch.from_numpy(rng.integers(0, 2**32 - 2**16, (16, 9),
                                         dtype=np.int64))
    assert torch.equal(TP.prefix_final_adder(cols, tile_b=tile_b),
                       TP.prefix_final_adder_ref(cols))


def test_prefix_adder_worst_case_ripple():
    """All-MASK columns: the carry must ripple the full width."""
    width = 16
    cols = np.full((4, width), RL.MASK, np.uint32)
    cols[:, 0] += 1
    want = np.asarray(RP.fast_final_adder(jnp.asarray(cols)))
    got = _port(cols)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    assert (got == 0).all()              # 2**(16W) wraps to zero


def test_prefix_adder_top_of_the_valid_domain():
    """Columns just below 2**32 - 2**16 (the reference's stated limit)."""
    rng = np.random.default_rng(11)
    top = 2**32 - 2**16 - 1
    cols = rng.integers(top - 2**20, top, (32, 24), dtype=np.uint32)
    cols[0] = top
    want = np.asarray(RP.prefix_final_adder(jnp.asarray(cols), tile_b=8,
                                            interpret=True))
    np.testing.assert_array_equal(_port(cols), want.astype(np.int32))


@pytest.mark.parametrize("bits", [32, 128, 256])
def test_prefix_adder_on_ppm_columns_gives_the_product(bits):
    """The slice's path: the port's PPM columns through the adder are the
    product, and equal the reference's PPM through its kernel."""
    rng = np.random.default_rng(bits)
    a = RL.random_limbs(rng, (24,), bits)
    b = RL.random_limbs(rng, (24,), bits)
    cols = TL.ppm(TL.from_numpy(a, "cpu"), TL.from_numpy(b, "cpu"))
    got = TP.fast_final_adder(cols)
    want = RP.prefix_final_adder(RL.ppm(jnp.asarray(a), jnp.asarray(b)),
                                 tile_b=8, interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    assert TL.batch_from_limbs(got) == [
        TL.from_limbs(x) * TL.from_limbs(y) for x, y in zip(a, b)]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 2**31), min_size=2, max_size=24))
def test_prefix_adder_property(colvals):
    cols = np.array(colvals, np.uint32)[None]
    want = np.asarray(RP.prefix_final_adder(jnp.asarray(cols), tile_b=1,
                                            interpret=True))
    np.testing.assert_array_equal(_port(cols), want.astype(np.int32))


def test_prefix_adder_shape_errors():
    with pytest.raises(ValueError):
        TP.prefix_final_adder(torch.zeros((2, 3), dtype=torch.int64),
                              tile_b=0)
    with pytest.raises(ValueError):      # a CPU column is not a CUDA one
        _build.check_cuda_operands("prefix_adder",
                                   torch.zeros((2, 3), dtype=torch.int64),
                                   dtype=torch.int64)
