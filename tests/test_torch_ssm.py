"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the
JAX package's, on the CPU.

One smoke mamba2-370m layer (d_model 128, 8 heads of 32, state 16,
chunk 32; ``params_from_numpy`` keeps ``dt_bias``, ``A_log`` and ``D``
float32) and the same bf16 input through both packages.  The prefill at
37, 64 and 100 tokens takes the padding path (37, 100) and the
inter-chunk scan (64, 100).  Tolerances: the layer's bf16 output within
max|d| / std(reference) 0.05 (bf16 roundings of the projections may
fall apart); the float32 final state within rtol 1e-4; the bf16 conv
cache (pre-conv rows) and the convolution within one bf16 ulp.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import ssm as RS
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

from test_torch_models import port_model, ref_params, rel_err

ARCH = "mamba2-370m"
TOL = 0.05
B = 2


@pytest.fixture(scope="module")
def block():
    rcfg = RCFG.get_config(ARCH, smoke=True)
    params = ref_params(rcfg)
    p = jax.tree_util.tree_map(lambda a: a[1, 0], params["groups"]["mamba"])
    model = port_model(ARCH, params)
    return rcfg, p, model.cfg, model.layers[1]


def inputs(length, d, seed):
    x = np.random.default_rng(seed).standard_normal((B, length, d))
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.asarray(xb, np.float32)).to(
        torch.bfloat16)


def within_ulp(got, want):
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -6)
    return (np.abs(got.float().numpy() - want) <= ulp).all()


def fresh_cache(cfg):
    return TT.init_cache([TS.ssm_cache_spec(cfg, B)], "cpu")[0]


def test_float32_leaves_and_cache_spec(block):
    rcfg, p, tcfg, tp = block
    for name in ("dt_bias", "A_log", "D"):
        assert getattr(tp, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(p[name]))
    ref = RS.ssm_cache_spec(rcfg, B)
    got = TS.ssm_cache_spec(tcfg, B)
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in ref.items()} == \
        {k: (s.shape, str(s.dtype).split(".")[-1]) for k, s in got.items()}


@pytest.mark.parametrize("length", [37, 64, 100])
def test_prefill_matches_reference(block, length):
    rcfg, p, tcfg, tp = block
    xb, xt = inputs(length, rcfg.d_model, seed=length)
    want, rcache = RS.ssm_apply(p, xb, rcfg, None, "prefill")
    cache = fresh_cache(tcfg)
    got = TS.ssm_apply(tp, xt, tcfg, "prefill", cache=cache)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    assert rel_err(got.float().numpy(), want) < TOL
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(rcache["state"]), rtol=1e-4,
                               atol=1e-6)
    assert cache["conv"].dtype == torch.bfloat16
    assert within_ulp(cache["conv"], rcache["conv"])


@pytest.mark.parametrize("length", [37, 64])
def test_decode_step_matches_reference(block, length):
    """One recurrent step from the reference's prefill cache."""
    rcfg, p, tcfg, tp = block
    xb, _ = inputs(length, rcfg.d_model, seed=length)
    _, rcache = RS.ssm_apply(p, xb, rcfg, None, "prefill")
    ub, ut = inputs(1, rcfg.d_model, seed=length + 1)
    want, rnew = RS.ssm_apply(p, ub, rcfg, None, "decode", cache=rcache)
    cache = {"conv": torch.from_numpy(np.asarray(rcache["conv"], np.float32))
             .to(torch.bfloat16),
             "state": torch.from_numpy(np.array(rcache["state"]))}
    got = TS.ssm_apply(tp, ut, tcfg, "decode", cache=cache)
    assert rel_err(got.float().numpy(), want) < TOL
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(rnew["state"]), rtol=1e-4,
                               atol=1e-6)
    assert within_ulp(cache["conv"], rnew["conv"])


def test_causal_conv_matches_reference(block):
    rcfg, p, _, tp = block
    ch = rcfg.d_inner + 2 * rcfg.ssm_state
    xb, xt = inputs(40, ch, seed=9)
    want = RS._causal_conv(xb, p["conv_w"], p["conv_b"])
    got = TS._causal_conv(xt, tp.conv_w, tp.conv_b)
    assert got.dtype == torch.bfloat16
    assert within_ulp(got, want)


def test_prefill_needs_the_conv_window(block):
    """The prefill cache keeps the last kw - 1 = 3 pre-conv rows."""
    _, _, tcfg, tp = block
    _, xt = inputs(2, tcfg.d_model, seed=2)
    with pytest.raises(ValueError, match="at least 3 tokens"):
        TS.ssm_apply(tp, xt, tcfg, "prefill", cache=fresh_cache(tcfg))
    assert TS.ssm_apply(tp, xt, tcfg, "prefill").shape == xt.shape
