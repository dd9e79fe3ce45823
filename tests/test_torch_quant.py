"""The port's int8 path (kernel #7, ``quant``, ``optim.compress``)
against the JAX reference, bit for bit.

The same seeded numpy inputs go through the reference (its Pallas
``int8_matmul`` in interpret mode, ``quantized_matmul``,
``quantize_rows`` and ``optim.compress``) and the port on the CPU.
Tolerance is exact: int8 ``q`` and float32 scales, errors and
dequantized values equal, bf16 outputs compared as bits.  Sizes are the
reference tests' own (``tests/test_kernels.py``, ``tests/test_substrate.
py``) plus ragged shapes, which the port's kernel takes itself.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import int8_matmul as RI
from repro.optim import compress as RC
import repro_torch.quant
from repro_torch.kernels import _build
from repro_torch.kernels import int8_matmul as TI
from repro_torch.optim import compress as TC


def _same_bf16(port, ref):
    assert port.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        port.view(torch.int16).numpy().view(np.uint16),
        np.asarray(ref).view(np.uint16))


def _same_f32(port, ref):
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy().view(np.uint32),
                                  np.asarray(ref, np.float32).view(np.uint32))


def _int8_operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (m, k), dtype=np.int8),
            rng.integers(-127, 128, (k, n), dtype=np.int8),
            rng.random(m, dtype=np.float32) + 0.01,
            rng.random(n, dtype=np.float32) + 0.01)


def _port_matmul(ops, **kwargs):
    before = _build.launch_counts()
    out = TI.int8_matmul(*(torch.from_numpy(o) for o in ops), **kwargs)
    assert _build.launch_counts() == before      # CPU: no kernel launch
    return out


# ------------------------------------------------------------ int8_matmul

@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 256, 128),
                                   (32, 512, 64), (256, 128, 256)])
def test_int8_matmul_matches_reference_kernel(m, k, n):
    ops = _int8_operands(m + k + n, m, k, n)
    want = RI.int8_matmul(*(jnp.asarray(o) for o in ops), block_m=32,
                          block_n=32, block_k=32, interpret=True)
    _same_bf16(_port_matmul(ops, block_m=32, block_n=32, block_k=32), want)
    _same_bf16(TI.int8_matmul_ref(*(torch.from_numpy(o) for o in ops)),
               RI.int8_matmul_ref(*(jnp.asarray(o) for o in ops)))


@pytest.mark.parametrize("bk", [32, 64, 128])
def test_int8_matmul_fold_depth_invariance(bk):
    """CT = K/block_k changes nothing (exact int32 accumulation)."""
    x, w, _, _ = _int8_operands(bk, 128, 128, 128)
    ones = np.ones(128, np.float32)
    ops = (x, w, ones, ones)
    want = RI.int8_matmul(*(jnp.asarray(o) for o in ops), block_m=64,
                          block_n=64, block_k=bk, interpret=True,
                          out_dtype=jnp.float32)
    _same_f32(_port_matmul(ops, block_m=64, block_n=64, block_k=bk,
                           out_dtype=torch.float32), want)


@pytest.mark.parametrize("m,k,n", [(33, 70, 45), (1, 1, 1), (17, 300, 3)])
def test_int8_matmul_ragged_shapes(m, k, n):
    """Shapes no block divides: the port's wrapper takes them (on the
    card its kernel masks the edges); the reference's plain version is
    the oracle, as its ``quantized_matmul`` uses it there."""
    ops = _int8_operands(m * n, m, k, n)
    want = RI.int8_matmul_ref(*(jnp.asarray(o) for o in ops))
    _same_bf16(_port_matmul(ops, block_m=32, block_n=32, block_k=32), want)
    want32 = RI.int8_matmul_ref(*(jnp.asarray(o) for o in ops),
                                out_dtype=jnp.float32)
    _same_f32(_port_matmul(ops, out_dtype=torch.float32), want32)


def test_int8_matmul_argument_errors():
    x, w, sx, sw = (torch.from_numpy(o) for o in _int8_operands(1, 4, 8, 2))
    with pytest.raises(ValueError):
        TI.int8_matmul(x, w.T, sx, sw)
    with pytest.raises(ValueError):
        TI.int8_matmul(x, w, sx[:3], sw)
    with pytest.raises(ValueError):
        TI.int8_matmul(x, w, sx, sw, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        TI.int8_matmul(x, w, sx, sw, block_k=0)


# ------------------------------------------------------- quantize / quant

@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantize_rows_matches_reference(axis):
    rng = np.random.default_rng(axis + 5)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    x[3] = 0.0                                   # an all-zero row: scale 1
    x[:, 7] = 0.0
    q, s = repro_torch.quant.quantize_rows(torch.from_numpy(x), axis=axis)
    rq, rs = RI.quantize_rows(jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    _same_f32(s, rs)
    back = q.float() * (s[:, None] if axis != 0 else s[None, :])
    step = (s[:, None] if axis != 0 else s[None, :]).numpy()
    assert (np.abs(back.numpy() - x) <= 0.5 * step + 1e-6).all()


def test_quantize_rows_columns_of_a_gemma2_weight_match_reference():
    """Per-column scales of a (3584, 512) slice of gemma2-9b's MLP weight
    shape, bit for bit (the scale divides by a tensor on the operand's
    device, the reference's true division)."""
    w = np.random.default_rng(17).standard_normal((3584, 512)).astype(
        np.float32)
    q, s = repro_torch.quant.quantize_rows(torch.from_numpy(w), axis=0)
    rq, rs = RI.quantize_rows(jnp.asarray(w), axis=0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    _same_f32(s, rs)


@pytest.mark.parametrize("m,k,n,block", [(64, 256, 64, 64),
                                         (128, 128, 256, 128),
                                         (50, 96, 40, 32)])
def test_quantized_matmul_matches_reference(m, k, n, block):
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    want = RI.quantized_matmul(jnp.asarray(x), jnp.asarray(w), block=block)
    got = repro_torch.quant.quantized_matmul(torch.from_numpy(x),
                                             torch.from_numpy(w),
                                             block=block)
    _same_bf16(got, want)
    _same_bf16(TI.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   use_kernel=False), want)
    # int8 with per-row/col scales: ~1% relative error on gaussian data
    got = got.float().numpy()
    rel = np.linalg.norm(got - x @ w) / np.linalg.norm(x @ w)
    assert rel < 0.02, rel


def test_quant_reexports_the_kernel_package():
    assert repro_torch.quant.quantized_matmul is TI.quantized_matmul
    assert repro_torch.quant.quantize_rows is TI.quantize_rows


# --------------------------------------------------------- optim.compress

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((16, 32)).astype(np.float32),
            "b": [rng.standard_normal((40,)).astype(np.float32),
                  (rng.standard_normal((3, 4, 20)) * 1e-3).astype(
                      np.float32)]}


def _tree(grads, fn):
    return {"a": fn(grads["a"]), "b": [fn(v) for v in grads["b"]]}


def _pairs(port, ref):
    return ([port["a"]] + list(port["b"]), [ref["a"]] + list(ref["b"]))


def test_compress_round_trip_matches_reference():
    grads = _grads(0)
    tg, rg = _tree(grads, torch.from_numpy), _tree(grads, jnp.asarray)
    terr, rerr = TC.init_error(tg), RC.init_error(rg)
    for e in _pairs(terr, rerr)[0]:
        assert e.dtype == torch.float32 and not e.any()
    for _ in range(3):                  # error feedback carried over steps
        tq, ts, terr = TC.compress_grads(tg, terr)
        rq, rs, rerr = RC.compress_grads(rg, rerr)
        for p, r in zip(*_pairs(tq, rq)):
            assert p.dtype == torch.int8
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        for p, r in zip(*_pairs(ts, rs)):
            _same_f32(p, r)
        for p, r in zip(*_pairs(terr, rerr)):
            _same_f32(p, r)
        tback = TC.decompress_grads(tq, ts, tg)
        rback = RC.decompress_grads(rq, rs, rg)
        for p, r in zip(*_pairs(tback, rback)):
            _same_f32(p, r)


def test_compress_error_feedback_holds_the_residual():
    grads = {"a": torch.from_numpy(_grads(1)["a"])}
    err = TC.init_error(grads)
    qs, ss, err2 = TC.compress_grads(grads, err)
    back = TC.decompress_grads(qs, ss, grads)
    assert torch.equal(err2["a"], grads["a"] - back["a"])
    step = ss["a"][:, None]
    assert ((back["a"] - grads["a"]).abs() <= 0.5 * step + 1e-6).all()


def test_compress_tree_mismatch_raises():
    grads = {"a": torch.zeros(3), "b": torch.zeros(3)}
    with pytest.raises(ValueError):
        TC.compress_grads(grads, {"a": torch.zeros(3)})
