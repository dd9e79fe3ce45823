"""The port's training losses and their gradients against the JAX
package's ``jax.value_and_grad(model.train_loss)``, on the CPU.

One smoke config of each family and variant: qwen3-32b (dense, qk-norm),
gemma2-9b (softcaps, local/global), llama4-scout (MoE: the router's aux
term, expert choice at 2 x 128 tokens), mamba2-370m (SSM), zamba2-1.2b
(hybrid, one shared block), hubert-xlarge (encoder: only masked frames
scored) and paligemma-3b (VLM: image positions never scored).  Both
packages get the same parameters (``ref_params``, carried over by
``params_from_numpy``) and the same batch, drawn with numpy.

Tolerances, on the loss and on every gradient leaf mapped through
``param_layout`` (relative L2 error |g - want| / |want|):

* float32 parameters (every activation float32): loss within 1e-5 of
  the reference's, each leaf within 1e-4 (measured: ~1e-6).  This holds
  the arithmetic, expert choice's routing included.
* bf16 parameters (the configs' dtype): loss within 1e-3, and each leaf
  within 2e-2 of the reference's float32 gradient, or within twice the
  reference's own bf16 gradient's distance from it (on that leaf, or on
  its median leaf) where that is larger.  bf16 rounds activations at
  the reference's points but not in its order (the port sums attention
  in float64, the reference rescales in float32), and the reference's
  own bf16 gradients lie 1.4-1.9% from its float32 ones (up to 19%
  for routed experts past the first layer, where one rounding moves a
  token across an expert's top-C cut): a fixed bound on port against
  reference would test that noise.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import base as RB
from repro.models import build_model as r_build
from repro_torch import configs as TCFG
from repro_torch.models import api as TAPI
from repro_torch.models import base as TB
from repro_torch.models import build_model, transformer as TT

from test_torch_models import port_model, ref_params

ARCHS = ("qwen3-32b", "gemma2-9b", "llama4-scout-17b-a16e", "mamba2-370m",
         "zamba2-1.2b", "hubert-xlarge", "paligemma-3b")
LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
F32_GRAD_RTOL = 1e-4
BF16_GRAD_RTOL = 2e-2
B, S = 2, 128            # two CE chunks and two attention chunks of 64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs one
    module a worker and several workers a machine, where eight threads a
    worker oversubscribe the cores and this module's small ops spin
    more than they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def batch_for(cfg, seed=3):
    """numpy batch of ``cfg``'s family at (B, S)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "encoder":
        return {"frames": rng.standard_normal((B, S, 512)).astype(
                    np.float32),
                "mask": rng.random((B, S)) < 0.3, "labels": labels}
    mask = (rng.random((B, S)) < 0.9).astype(np.float32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), "labels": labels, "mask": mask}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_vis)).astype(np.float32)
    return batch


def _ref_batch(batch):
    bf16 = ("frames", "image_embeds")
    return {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else None)
            for k, v in batch.items()}


def _port_batch(batch):
    bf16 = ("frames", "image_embeds")
    return {k: torch.from_numpy(np.asarray(v)).to(torch.bfloat16)
            if k in bf16 else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


def ref_loss_and_grads(arch, params, batch):
    model = r_build(RCFG.get_config(arch, smoke=True))
    loss, grads = jax.value_and_grad(model.train_loss)(params,
                                                       _ref_batch(batch))
    return float(loss), grads


def port_loss_and_grads(model, batch):
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    loss = model.train_loss(_port_batch(batch))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


def leaf_of(tree, path, idx):
    for key in path:
        tree = tree[key]
    return np.asarray(tree[idx] if idx else tree, np.float32)


def rel_l2(got, want):
    got = np.asarray(torch.as_tensor(got).detach().to(torch.float32))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    rcfg = RCFG.get_config(arch, smoke=True)
    tcfg = TCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    params32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      params)
    batch = batch_for(rcfg)
    runs = {}
    for dtype, tree in ((torch.float32, params32), (torch.bfloat16, params)):
        want_loss, want_grads = ref_loss_and_grads(arch, tree, batch)
        model = port_model(arch, params)
        if dtype == torch.float32:
            model.float()
        got_loss, got_grads = port_loss_and_grads(model, batch)
        assert np.isfinite(got_loss)
        assert abs(got_loss - want_loss) <= \
            LOSS_RTOL[dtype] * abs(want_loss), (dtype, got_loss, want_loss)
        runs[dtype] = got_grads, want_grads
    errs = {}              # leaf -> (port f32, port bf16, reference bf16)
    for name, path, idx, _ in TAPI.param_layout(tcfg):
        truth = leaf_of(runs[torch.float32][1], path, idx)
        errs[name] = (rel_l2(runs[torch.float32][0][name], truth),
                      rel_l2(runs[torch.bfloat16][0][name], truth),
                      rel_l2(leaf_of(runs[torch.bfloat16][1], path, idx),
                             truth))
    assert len(errs) == len(runs[torch.float32][0])
    median_own = float(np.median([e[2] for e in errs.values()]))
    bad = {name: e for name, e in errs.items()
           if not (e[0] <= F32_GRAD_RTOL and e[1] <= max(
               BF16_GRAD_RTOL, 2 * e[2], 2 * median_own))}
    assert not bad, bad


@pytest.mark.parametrize("s, chunk, cap", [(128, 64, None), (128, 48, None),
                                           (96, 512, 30.0), (64, 64, 5.0)])
def test_cross_entropy_chunked_matches_reference(s, chunk, cap):
    """Two chunks, the one-chunk fallback (48 does not divide 128), a
    chunk past the sequence, and a softcap; loss and d/dx."""
    rng = np.random.default_rng(s + chunk)
    vocab, d = 96, 16
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    w = rng.standard_normal((d, vocab)).astype(np.float32)
    labels = rng.integers(0, vocab, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.7).astype(np.float32)

    def ref(xj):
        return RB.cross_entropy_chunked(
            lambda xs: xs @ jnp.asarray(w, jnp.bfloat16), xj,
            jnp.asarray(labels), jnp.asarray(mask), vocab, chunk=chunk,
            final_cap=cap)
    want, want_dx = jax.value_and_grad(ref)(jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    got = TB.cross_entropy_chunked(
        lambda xs: xs @ wt, xt, torch.from_numpy(labels),
        torch.from_numpy(mask), chunk=chunk, final_cap=cap)
    (dx,) = torch.autograd.grad(got, xt)
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert rel_l2(dx, np.asarray(want_dx, np.float32)) <= 1e-2


def test_empty_mask_gives_zero_loss():
    """cnt is clamped to 1, as the reference's ``maximum(cnt, 1)``."""
    x = torch.randn(1, 8, 4)
    loss = TB.cross_entropy_chunked(lambda xs: xs @ torch.ones(4, 6), x,
                                    torch.zeros(1, 8, dtype=torch.long),
                                    torch.zeros(1, 8), chunk=4)
    assert float(loss) == 0.0


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b",
                                  "hubert-xlarge"])
def test_remat_changes_no_bit(arch):
    """Recomputing each unit in the backward pass (``cfg.remat``) gives
    the loss and every gradient of the run that keeps its activations,
    bit for bit: gemma3's groups of 6 and tail of 2, zamba2's groups
    with their shared block and tail, hubert's layers."""
    rcfg = RCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    batch = batch_for(rcfg)
    on = port_loss_and_grads(port_model(arch, params), batch)
    off = port_loss_and_grads(port_model(arch, params, remat=False), batch)
    assert on[0] == off[0]
    assert all(torch.equal(on[1][n], off[1][n]) for n in on[1])


def test_remat_units_are_the_reference_scan_bodies():
    """gemma3-1b: 4 groups of 5 local + 1 global, then 2 tail layers;
    qwen3: one layer a unit."""
    assert TT.remat_units(TCFG.get_config("gemma3-1b")) == [6] * 4 + [1] * 2
    assert TT.remat_units(TCFG.get_config("qwen3-32b", smoke=True)) == \
        [1] * 4


def test_train_projection_is_one_matmul():
    """Train mode: one ``x @ w`` over every row (its bits are those of
    the plain product); the serving path keeps its 64-row calls."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 50, 32), generator=gen).to(torch.bfloat16)
    w = torch.randn((32, 24), generator=gen).to(torch.bfloat16)
    assert torch.equal(TB.matmul(x, w, train=True), x @ w)
    rows = [TB.matmul(x[i:i + 1], w) for i in range(3)]
    assert torch.equal(TB.matmul(x, w), torch.cat(rows))


def test_gradients_only_where_requested():
    """Parameters come without gradients (serving); ``requires_grad_``
    turns them on for ``train_loss``."""
    cfg = TCFG.get_config("qwen3-32b", smoke=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = _port_batch(batch_for(cfg))
    assert not model.train_loss(batch).requires_grad
    model.requires_grad_(True)
    loss = model.train_loss(batch)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_ssd_gradients_stay_finite_past_exp_overflow():
    """With dt ~ 4 a 32-step chunk's decay exponents above the diagonal
    sum past 88 and overflow float32.  The reference masks them after
    ``exp`` and its gradients turn non-finite (0 * inf); the port masks
    them before, with the same forward values, and its gradients stay
    finite and match the reference's wherever those are finite."""
    from repro.models import ssm as RS
    from repro_torch.models import ssm as TS
    rcfg = RCFG.get_config("mamba2-370m", smoke=True)
    tcfg = TCFG.get_config("mamba2-370m", smoke=True)
    rp = RB.init_params(RS.ssm_template(rcfg), jax.random.PRNGKey(0))
    rp["dt_bias"] = jnp.full(rp["dt_bias"].shape, 4.0, jnp.float32)
    u = np.random.default_rng(1).standard_normal(
        (1, 32, rcfg.d_model)).astype(np.float32)
    uj = jnp.asarray(u, jnp.bfloat16)

    def ref(p):
        y, _ = RS.ssm_apply(p, uj, rcfg, None, "train")
        return jnp.sum(y.astype(jnp.float32))
    want, want_g = jax.value_and_grad(ref)(rp)
    assert not np.isfinite(np.asarray(want_g["dt_bias"])).all()

    class P(torch.nn.Module):
        pass
    p = P()
    for k, v in rp.items():
        t = torch.from_numpy(np.asarray(v, np.float32))
        p.register_parameter(k, torch.nn.Parameter(t.to(
            torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)))
    out = TS.ssm_apply(p, torch.from_numpy(u).to(torch.bfloat16), tcfg,
                       "train")
    got = out.to(torch.float32).sum()
    grads = dict(zip(rp, torch.autograd.grad(got, [getattr(p, k)
                                                   for k in rp])))
    assert abs(float(got) - float(want)) <= 1e-3 * abs(float(want))
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
        w = np.asarray(want_g[k], np.float32)
        if np.isfinite(w).all():
            assert rel_l2(g, w) <= BF16_GRAD_RTOL, k
