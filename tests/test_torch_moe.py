"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

One smoke layer's parameters (``params_from_numpy``: the router stays
float32) and the same bf16 activations go through both packages' dense
token choice (llama4-scout's top-1 sigmoid with its shared expert,
dbrx's top-4 softmax), expert choice (each expert picks its top-C
tokens; a token picked by several experts sums their rows) and
``moe_apply`` as a whole, with the router z-loss.  Tolerances: the
expert outputs within max|d| / std(reference) 0.02 (bf16 products summed
in float32 in both, rounded once; the reference rounds its expert-choice
scatter-add at every add); ``moe_apply``'s x + moe(x) within one bf16
ulp of the sum plus one of moe(x); the z-loss within rtol 1e-5
(float32); ``top_k``'s indices equal ``jax.lax.top_k``'s on ties.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import moe as RM
from repro_torch import configs as TCFG
from repro_torch.models import moe as TM

from test_torch_models import port_model, ref_params, rel_err

ARCHS = ("llama4-scout-17b-a16e", "dbrx-132b")
TOL = 0.02


def layer(arch, n=1):
    """(reference cfg, reference layer params, port cfg, port layer) of
    layer ``n`` of a smoke model."""
    rcfg = RCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    p = jax.tree_util.tree_map(lambda a: a[n],
                               params["groups"]["global"]["moe"])
    model = port_model(arch, params)
    return rcfg, p, model.cfg, model.layers[n].moe


def activations(b, s, d, seed=3):
    x = np.random.default_rng(seed).standard_normal((b, s, d))
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.asarray(xb, np.float32)).to(
        torch.bfloat16)


def router_logits(rp, tp, xb, xt, rcfg):
    """Both packages' normed input and float32 router logits."""
    from repro.models import base as RB
    from repro_torch.models import base as TB
    rxn = RB.rms_norm(xb, rp["norm"], rcfg.norm_eps)
    txn = TB.rms_norm(xt, tp.norm, rcfg.norm_eps)
    return (rxn, rxn.astype(jnp.float32) @ rp["router"], txn,
            TB.matmul(txn.to(torch.float32), tp.router))


def test_router_stays_float32():
    _, rp, _, tp = layer("dbrx-132b")
    assert tp.router.dtype == torch.float32
    np.testing.assert_array_equal(tp.router.numpy(), np.asarray(rp["router"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_token_choice_matches_reference(arch):
    rcfg, rp, tcfg, tp = layer(arch)
    xb, xt = activations(2, 5, rcfg.d_model)
    rxn, rlog, txn, tlog = router_logits(rp, tp, xb, xt, rcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), rtol=1e-5,
                               atol=1e-6)
    want = RM._dense_token_choice(rp, rxn, rlog, rcfg)
    got = TM._dense_token_choice(tp, txn, tlog, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5,
                                                         rcfg.d_model)
    assert rel_err(got.float().numpy(), want) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_choice_matches_reference(arch):
    """T = 128 tokens on 4 experts: C = 32 (llama4, top-1) or 128 (dbrx,
    top-4: every expert picks every token)."""
    rcfg, rp, tcfg, tp = layer(arch)
    xb, xt = activations(2, 64, rcfg.d_model)
    rxn, rlog, txn, tlog = router_logits(rp, tp, xb, xt, rcfg)
    affin = torch.softmax(tlog.reshape(128, -1), dim=-1)
    _, idx = TM.top_k(affin.T, max(1, 128 * rcfg.top_k // rcfg.n_experts))
    picks = torch.bincount(idx.reshape(-1), minlength=128)
    assert picks.max() >= 2          # some token sums several experts
    want = RM._expert_choice(rp, rxn, rlog, rcfg, None)
    got = TM._expert_choice_local(tp, txn, tlog, tcfg, 1)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), want) < TOL


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_zloss_match_reference(arch, decode):
    """The update x + moe(x) within one bf16 ulp of the sum plus one of
    moe(x) (the residual dominates the sum, and the reference rounds its
    scatter at every add), and the z-loss; a prefill of 2 x 64 takes
    expert choice, a decode token choice."""
    rcfg, rp, tcfg, tp = layer(arch, n=2)
    xb, xt = activations(2, 1 if decode else 64, rcfg.d_model, seed=4)
    rout, rz = RM.moe_apply(rp, xb, rcfg, None, decode=decode)
    tout, tz = TM.moe_apply(tp, xt, tcfg, decode=decode)
    np.testing.assert_allclose(tz.item(), float(rz), rtol=1e-5)
    want = np.asarray(rout, np.float32)
    x = np.asarray(xb, np.float32)

    def ulp(v):
        return 2.0 ** -7 * np.maximum(np.abs(v), 2.0 ** -6)
    assert tout.dtype == torch.bfloat16
    assert (np.abs(tout.float().numpy() - want)
            <= ulp(want) + ulp(want - x)).all()


def test_top_k_takes_the_lower_index_on_ties():
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5],
                  [0.2, 0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3, 5):
        vals, idx = TM.top_k(torch.from_numpy(x), k)
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_combine_sums_every_expert_of_a_token():
    """Token 1 is picked by all three experts, token 3 by none: the
    float32 sum of the rows, rounded once."""
    g = torch.Generator().manual_seed(7)
    y = torch.randn((3, 2, 8), generator=g).to(torch.bfloat16)
    idx = torch.tensor([[1, 0], [2, 1], [1, 4]])

    def combine():
        return TM._group_combine(y[None], idx[None], 5)[0].to(y.dtype)
    got = combine()
    want = torch.zeros((5, 8), dtype=torch.float64)
    for e in range(3):
        for c in range(2):
            want[idx[e, c]] += y[e, c].double()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.float().to(torch.bfloat16))
    assert torch.equal(combine(), got)
    assert got[3].count_nonzero() == 0
