"""The port's model stack (``repro_torch.{configs,models}``) against the
JAX package's, on the CPU.

Configs, templates, parameter counts and cache specs are compared field
for field; the integer dots of the int8 decode attention exactly.  Float
results are compared at the reference's own tolerances: attention
against the reference and a naive softmax in float32 (2e-4, as
``tests/test_attention.py``); logits as max|d| / std(reference logits),
0.05 dense, 0.1 gemma2 (one bf16 ulp at its logit scale reads as 6% of
std), 0.25 with the int8 KV cache (``tests/test_decode_consistency.py``).
Both packages get the same parameters: numpy draws in each leaf's dtype
(bf16, or float32 for the MoE router and the SSM's ``dt_bias``,
``A_log`` and ``D``), carried over by ``params_from_numpy``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import attention as RA
from repro.models import base as RB
from repro.models import build_model as r_build
from repro.models import transformer as RT
from repro_torch import configs as TCFG
from repro_torch.models import attention as TA
from repro_torch.models import base as TB
from repro_torch.models import api as TAPI
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as TT

DENSE = ("qwen3-32b", "minitron-8b", "gemma3-1b", "gemma2-9b")
TOL = {"qwen3-32b": 0.05, "minitron-8b": 0.05, "gemma3-1b": 0.05,
       "gemma2-9b": 0.1}
INT8_TOL = 0.25
P0, STEPS, B, S_CAP = 64, 3, 2, 128


# ------------------------------------------------------------- helpers

def ref_params(cfg, seed=0):
    """The reference's parameter tree of ``cfg`` filled from numpy in
    each leaf's dtype: uniform draws with the initializers' standard
    deviations (quicker than normal ones at full width); norm scales are
    nonzero so ``1 + scale`` is exercised."""
    rng = np.random.default_rng(seed)

    def one(p):
        x = rng.random(p.shape, dtype=np.float32)
        x -= 0.5
        x *= math.sqrt(12.0)                 # unit standard deviation
        if p.init == "zeros":
            x *= 0.1
        elif p.init == "scaled":
            x /= math.sqrt(p.shape[-2])
        else:
            x *= p.scale
        return jnp.asarray(x, p.dtype)
    return jax.tree_util.tree_map(one, r_build(cfg).template(),
                                  is_leaf=RB.is_param)


def as_numpy(tree, bits=False):
    """JAX tree -> numpy float32 (bf16 leaves as uint16 bit views with
    ``bits``)."""
    def one(a):
        if bits and a.dtype == jnp.bfloat16:
            return np.asarray(a).view(np.uint16)
        return np.asarray(a, np.float32)
    return jax.tree_util.tree_map(one, tree)


def port_model(arch, params, **overrides):
    cfg = TCFG.get_config(arch, smoke=True, **overrides)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_numpy(cfg, as_numpy(params), "cpu"))
    return model


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.std(want), 1e-3)


def tokens(vocab, n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, n)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", RCFG.ARCH_NAMES)
def test_config_registry_field_for_field(arch):
    assert TCFG.ARCH_NAMES == RCFG.ARCH_NAMES
    ref, port = RCFG.get_config(arch), TCFG.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert dataclasses.asdict(TCFG.get_config(arch, smoke=True, window=8)) \
        == dataclasses.asdict(RCFG.get_config(arch, smoke=True, window=8))
    for prop in ("padded_vocab", "d_inner", "n_ssm_heads"):
        assert getattr(port, prop) == getattr(ref, prop)
    for shape in RCFG.SHAPES:
        assert TCFG.cell_runnable(arch, shape) == \
            RCFG.cell_runnable(arch, shape)


def test_shapes_and_skips_field_for_field():
    assert {k: dataclasses.asdict(v) for k, v in TCFG.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RCFG.SHAPES.items()}
    assert TCFG.SKIPS == RCFG.SKIPS


# ----------------------------------------------------------- templates

DTYPES = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
          torch.float32: jnp.float32}
DTYPES_BACK = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _template_leaves(tpl, is_leaf, dtype=lambda d: d):
    out = {}
    for path, p in jax.tree_util.tree_flatten_with_path(
            tpl, is_leaf=is_leaf)[0]:
        out["/".join(k.key for k in path)] = (tuple(p.shape), p.logical,
                                              p.init, p.scale,
                                              dtype(p.dtype))
    return out


FULL_COUNTS = {"gemma2-9b": 9_241_404_928,
               "llama4-scout-17b-a16e": 107_771_827_200,
               "mamba2-370m": 368_494_080}
FLOAT32_LEAVES = {"router", "dt_bias", "A_log", "D"}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", RCFG.ARCH_NAMES)
def test_template_and_param_count(arch, smoke):
    """Every leaf's shape, axes, initializer and dtype: float32 for the
    MoE router and the SSM's dt_bias, A_log and D, bf16 elsewhere."""
    rcfg = RCFG.get_config(arch, smoke=smoke)
    tcfg = TCFG.get_config(arch, smoke=smoke)
    ref = r_build(rcfg)
    port = build_model(tcfg, device="cpu") if smoke else None
    tpl = TAPI.template(tcfg)
    assert _template_leaves(tpl, TB.is_param, DTYPES.get) == \
        _template_leaves(ref.template(), RB.is_param)
    for path, p in TB.leaves(tpl):
        assert p.dtype == (torch.float32 if path[-1] in FLOAT32_LEAVES
                           else torch.bfloat16), path
    assert TB.param_count(tpl) == ref.param_count()
    if not smoke and arch in FULL_COUNTS:
        assert ref.param_count() == FULL_COUNTS[arch]
    if port is not None:
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert sum(p.numel() for p in port.parameters()) == \
            ref.param_count()
        want = {name: p.dtype for name, _, _, p in TAPI.param_layout(tcfg)}
        assert {n: p.dtype for n, p in port.named_parameters()} == want
        assert not any(p.requires_grad for p in port.parameters())


def test_train_loss_is_not_ported():
    """``train_loss`` once raised ``NotImplementedError``; now it takes
    a batch and returns the mean cross-entropy, a finite float32 scalar
    (its parity with the reference: ``test_torch_train_loss.py``)."""
    cfg = TCFG.get_config("qwen3-32b", smoke=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(tokens(cfg.vocab_size, 64))
    loss = model.train_loss({"tokens": toks, "labels": toks})
    assert loss.shape == () and loss.dtype == torch.float32
    assert math.isfinite(float(loss))
    with pytest.raises(KeyError):
        model.train_loss({})


def test_build_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(TCFG.get_config("qwen3-32b", smoke=True))


def test_init_draws_the_reference_initializers():
    cfg = TCFG.get_config("gemma2-9b", smoke=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    layer = model.layers[0]
    assert torch.count_nonzero(layer.attn.norm) == 0
    assert abs(model.embed.float().std().item() - 0.02) < 0.002
    fan_in = cfg.n_heads * cfg.head_dim
    assert abs(layer.attn.wo.float().std().item()
               - 1 / math.sqrt(fan_in)) < 0.1 / math.sqrt(fan_in)
    again = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_params_from_numpy_unstacks_in_layer_order():
    cfg = RCFG.get_config("gemma3-1b", smoke=True)     # 5 local + 1, tail 2
    params = ref_params(cfg)
    tcfg = TCFG.get_config("gemma3-1b", smoke=True)
    sd = params_from_numpy(tcfg, as_numpy(params), "cpu")
    bits = params_from_numpy(tcfg, as_numpy(params, bits=True), "cpu")
    assert TT.layer_kinds(tcfg) == ["local"] * 5 + ["global"] + \
        ["local"] * 2
    want = {2: params["groups"]["local"]["attn"]["wq"][0, 2],
            5: params["groups"]["global"]["attn"]["wq"][0],
            7: params["tail"]["attn"]["wq"][1]}
    for layer, w in want.items():
        got = sd[f"layers.{layer}.attn.wq"]
        assert torch.equal(got.float(), _t(w))
        assert torch.equal(bits[f"layers.{layer}.attn.wq"], got)
    model = build_model(tcfg, "cpu")
    assert set(sd) == set(dict(model.named_parameters()))
    model.load_state_dict(sd)
    assert torch.equal(model.embed.float(), _t(params["embed"]))


def _pick(path, idx=()):
    def get(tree):
        for key in path.split("/"):
            tree = tree[key]
        return tree[idx] if idx else tree
    return get


#: per family: state-dict name -> where the reference's tree holds it
UNSTACKED = {
    "dbrx-132b": {                      # 4 layers, all global
        "layers.3.moe.router": _pick("groups/global/moe/router", (3,)),
        "layers.1.moe.w_down": _pick("groups/global/moe/w_down", (1,)),
        "layers.2.attn.wk": _pick("groups/global/attn/wk", (2,))},
    "llama4-scout-17b-a16e": {
        "layers.0.moe.router": _pick("groups/global/moe/router", (0,)),
        "layers.2.moe.w_gate": _pick("groups/global/moe/w_gate", (2,)),
        "layers.3.moe.shared.w_up": _pick("groups/global/moe/shared/w_up",
                                          (3,))},
    "mamba2-370m": {                    # 4 groups of 1 Mamba layer
        "layers.2.A_log": _pick("groups/mamba/A_log", (2, 0)),
        "layers.3.D": _pick("groups/mamba/D", (3, 0)),
        "layers.1.in_proj": _pick("groups/mamba/in_proj", (1, 0)),
        "embed": _pick("embed")},
    "zamba2-1.2b": {                    # 2 groups of 2, tail of 1
        "layers.1.dt_bias": _pick("groups/mamba/dt_bias", (0, 1)),
        "layers.2.conv_w": _pick("groups/mamba/conv_w", (1, 0)),
        "layers.4.A_log": _pick("tail/A_log", (0,)),
        "shared_attn.attn.wq": _pick("shared_attn/attn/wq"),
        "shared_attn.mlp.w_down": _pick("shared_attn/mlp/w_down")},
    "hubert-xlarge": {
        "layers.3.attn.wv": _pick("layers/attn/wv", (3,)),
        "frame_proj": _pick("frame_proj"),
        "mask_embed": _pick("mask_embed"),
        "lm_head": _pick("lm_head")},
    "paligemma-3b": {
        "layers.1.mlp.w_gate": _pick("groups/global/mlp/w_gate", (1,)),
        "vis_proj": _pick("vis_proj")},
}


@pytest.mark.parametrize("arch", list(UNSTACKED))
def test_params_from_numpy_unstacks_every_family(arch):
    """The unstacked order of each family, every leaf in its template's
    dtype: float32 leaves bit for bit, bf16 ones from float32 or bits."""
    rcfg = RCFG.get_config(arch, smoke=True)
    tcfg = TCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    sd = params_from_numpy(tcfg, as_numpy(params), "cpu")
    bits = params_from_numpy(tcfg, as_numpy(params, bits=True), "cpu")
    for name, get in UNSTACKED[arch].items():
        want = np.asarray(get(params))
        assert sd[name].dtype == DTYPES_BACK[want.dtype.name], name
        np.testing.assert_array_equal(sd[name].float().numpy(),
                                      want.astype(np.float32))
        assert torch.equal(bits[name], sd[name]), name
        if want.dtype == np.float32:    # the same bits, not just values
            np.testing.assert_array_equal(sd[name].numpy().view(np.uint32),
                                          want.view(np.uint32))
    model = build_model(tcfg, "cpu")
    assert set(sd) == set(dict(model.named_parameters()))
    model.load_state_dict(sd)
    f32 = [n for n, p in model.named_parameters() if p.dtype == torch.float32]
    assert len(f32) == {"moe": 4, "ssm": 12, "hybrid": 15}.get(
        tcfg.family, 0), f32
    if f32:                             # a float32 leaf takes no bf16 bits
        tree = as_numpy(params)
        *parents, key = _first_float32_path(params)
        leaf = tree
        for k in parents:
            leaf = leaf[k]
        leaf[key] = np.zeros(leaf[key].shape, np.uint16)
        with pytest.raises(TypeError, match="float32"):
            params_from_numpy(tcfg, tree, "cpu")



def _first_float32_path(tree, prefix=()):
    for key, sub in tree.items():
        if isinstance(sub, dict):
            found = _first_float32_path(sub, prefix + (key,))
            if found:
                return found
        elif sub.dtype == jnp.float32:
            return prefix + (key,)
    return None


# ------------------------------------------------------------- caches

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", DENSE)
def test_cache_spec_shapes_and_dtypes(arch, kv_dtype):
    rcfg = RCFG.get_config(arch, smoke=True, kv_cache_dtype=kv_dtype)
    tcfg = TCFG.get_config(arch, smoke=True, kv_cache_dtype=kv_dtype)
    ref = RT.lm_cache_spec(rcfg, 3, 96)
    k_local, _, n_groups, n_tail = RT.group_pattern(rcfg)
    want = []           # the reference's stacked tree, unstacked
    for _ in range(n_groups):
        if k_local:
            want += [{n: (s.shape[2:], s.dtype) for n, s in
                      ref["groups"]["local"].items()}] * k_local
        want.append({n: (s.shape[1:], s.dtype) for n, s in
                     ref["groups"]["global"].items()})
    if n_tail:
        want += [{n: (s.shape[1:], s.dtype) for n, s in
                  ref["tail"].items()}] * n_tail
    got = [{n: (tuple(s.shape), DTYPES[s.dtype]) for n, s in layer.items()}
           for layer in build_model(tcfg, "cpu").cache_spec(3, 96)]
    assert got == want


# ---------------------------------------------------------- primitives

def test_primitives_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    pairs = [
        (TB.rms_norm(_bf16(xb), _bf16(scale)),
         RB.rms_norm(xb, jnp.asarray(scale, jnp.bfloat16))),
        (TB.softcap(_bf16(xb) * 20, 30.0), RB.softcap(xb * 20, 30.0)),
        (TB.rope(_bf16(xb), torch.from_numpy(pos.copy()), 10_000.0),
         RB.rope(xb, jnp.asarray(pos), 10_000.0)),
    ]
    w1, w2 = (rng.standard_normal((32, 64)).astype(np.float32) * 0.2
              for _ in range(2))
    w3 = rng.standard_normal((64, 32)).astype(np.float32) * 0.2
    ws = [jnp.asarray(w, jnp.bfloat16) for w in (w1, w2, w3)]
    pairs.append((TB.swiglu(_bf16(xb), *(_bf16(w) for w in ws)),
                  RB.swiglu(xb, *ws)))
    pairs.append((TB.gelu_mlp(_bf16(xb), _bf16(ws[0]), _bf16(ws[2])),
                  RB.gelu_mlp(xb, ws[0], ws[2])))
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -6)
        assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_gemma_embedding_scale_rounds_to_bf16():
    cfg = TCFG.get_config("gemma2-9b")
    model = build_model(TCFG.get_config("gemma2-9b", smoke=True), "cpu")
    model.embed.data.fill_(1.0)
    x = TT.embed_tokens(model, torch.tensor([[0]]), cfg, scale=True)
    ref = jnp.sqrt(jnp.float32(3584)).astype(jnp.bfloat16)
    assert x.dtype == torch.bfloat16
    assert x[0, 0, 0].item() == float(ref) == 59.75


# ----------------------------------------------------------- attention

RNG = np.random.default_rng(9)


def _qkv(b=2, sq=256, sk=256, h=4, kv=2, d=32):
    return tuple(RNG.standard_normal(s).astype(np.float32) for s in
                 ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))


def _naive(q, k, v, mask_kind, window=None, prefix_len=None, cap=None):
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d).double()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / math.sqrt(d)
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(k.shape[1])[None, :]
    m = {"causal": kpos <= qpos,
         "local": (kpos <= qpos) & (kpos > qpos - (window or 0)),
         "prefix": (kpos <= qpos) | (kpos < (prefix_len or 0)),
         "none": torch.ones_like(kpos <= qpos)}[mask_kind]
    p = torch.softmax(torch.where(m, s, -1e30), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.double())
    return o.reshape(b, sq, h, d).float()


@pytest.mark.parametrize("mask_kind,window,prefix", [
    ("causal", None, None), ("local", 64, None),
    ("prefix", None, 48), ("none", None, None)])
@pytest.mark.parametrize("qc,kc", [(64, 64), (128, 32), (256, 256),
                                   (96, 96)])
def test_flash_matches_naive_and_reference(mask_kind, window, prefix, qc,
                                           kc):
    """(96, 96) does not divide 256: the single-chunk fallback."""
    q, k, v = _qkv()
    kw = dict(mask_kind=mask_kind, window=window, prefix_len=prefix,
              q_chunk=qc, k_chunk=kc)
    got = TA.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = _naive(_t(q), _t(k), _t(v), mask_kind, window, prefix)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    ref = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("mask_kind,window,prefix", [
    ("causal", None, None), ("local", 64, None), ("local", 100, None),
    ("prefix", None, 48)])
def test_banded_matches_masked_and_reference(mask_kind, window, prefix):
    q, k, v = _qkv()
    kw = dict(mask_kind=mask_kind, window=window, prefix_len=prefix,
              q_chunk=64, k_chunk=64)
    a = TA.flash_attention(_t(q), _t(k), _t(v), schedule="masked", **kw)
    b = TA.flash_attention(_t(q), _t(k), _t(v), schedule="banded", **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
    ref = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             schedule="banded", **kw)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    for n_q, n_k in ((4, 4), (8, 8), (4, 8)):
        assert TA._band_pairs(n_q, n_k, mask_kind, window, 64, prefix) == \
            RA._band_pairs(n_q, n_k, mask_kind, window, 64, prefix)


def test_softcap_applied_in_flash():
    q, k, v = _qkv(sq=64, sk=64)
    got = TA.flash_attention(_t(q), _t(k), _t(v), logit_cap=5.0,
                             q_chunk=32, k_chunk=32)
    want = _naive(_t(q), _t(k), _t(v), "causal", cap=5.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_flash_bf16_matches_reference():
    """bf16 operands: P rounds to bf16 before P.V in both packages."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(sq=128, sk=128))
    got = TA.flash_attention(_bf16(q), _bf16(k), _bf16(v), logit_cap=50.0,
                             q_chunk=64, k_chunk=64)
    ref = RA.flash_attention(q, k, v, logit_cap=50.0, q_chunk=64,
                             k_chunk=64)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), ref) < 0.05


@pytest.mark.parametrize("cap", [None, 50.0])
def test_decode_attention_matches_reference(cap):
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(sq=1, sk=96))
    valid = np.arange(96)[None, :] < np.array([[70], [96]])
    got = TA.decode_attention(_bf16(q), _bf16(k), _bf16(v),
                              torch.from_numpy(valid), logit_cap=cap)
    ref = RA.decode_attention(q, k, v, jnp.asarray(valid), logit_cap=cap)
    assert rel_err(got.float().numpy(), ref) < 0.05


def test_int_einsum_equals_reference_integer_dots():
    rng = np.random.default_rng(11)
    q8 = rng.integers(-127, 128, (2, 1, 2, 3, 256)).astype(np.int8)
    k8 = rng.integers(-127, 128, (2, 2048, 2, 256)).astype(np.int8)
    p8 = rng.integers(-127, 128, (2, 2, 3, 1, 2048)).astype(np.int8)
    q8[0, 0, 0, 0] = 127
    k8[0, :, 0] = 127                       # the largest dot
    p8[1, 0, 0, 0] = -127
    for eq, a, b in (("bqkgd,bskd->bkgqs", q8, k8),
                     ("bkgqs,bskd->bqkgd", p8, k8)):
        got = TA.int_einsum(eq, torch.from_numpy(a), torch.from_numpy(b))
        ref = jnp.einsum(eq, jnp.asarray(a), jnp.asarray(b),
                         preferred_element_type=jnp.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_decode_attention_int8_matches_reference():
    rng = np.random.default_rng(12)
    q = jnp.asarray(rng.standard_normal((2, 1, 4, 32)), jnp.bfloat16)
    kv = [jnp.asarray(rng.standard_normal((2, 80, 2, 32)), jnp.bfloat16)
          for _ in range(2)]
    (k8, ks), (v8, vs) = (RT._quant_kv(x) for x in kv)
    for x, (q_ref, s_ref) in zip(kv, ((k8, ks), (v8, vs))):
        q_port, s_port = TT._quant_kv(_bf16(x))
        np.testing.assert_array_equal(q_port.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(s_port.numpy(), np.asarray(s_ref))
    valid = np.arange(80)[None, :] < np.array([[33], [80]])
    args = (k8, ks, v8, vs, valid)
    got = TA.decode_attention_int8(
        _bf16(q), *(torch.from_numpy(np.array(a)) for a in args),
        logit_cap=50.0)
    ref = RA.decode_attention_int8(q, *(jnp.asarray(a) for a in args),
                                   logit_cap=50.0)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), ref) < 0.05


# ------------------------------------------------- batch and chunk bits

def test_matmul_rows_do_not_depend_on_the_batch():
    """A row's bits are the same whatever rows share its matmul call."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((200, 96), generator=g).to(torch.bfloat16)
    w = torch.randn((96, 48), generator=g).to(torch.bfloat16)
    full = TB.matmul(x, w)
    assert full.shape == (200, 48) and full.dtype == torch.bfloat16
    for lo, hi in ((0, 1), (3, 7), (60, 70), (130, 200), (199, 200)):
        assert torch.equal(TB.matmul(x[lo:hi], w), full[lo:hi])
    assert torch.equal(TB.matmul(x.reshape(2, 100, 96), w),
                       full.reshape(2, 100, 48))
    exact = (x.double() @ w.double()).float()
    np.testing.assert_allclose(full.float().numpy(), exact.numpy(),
                               rtol=2 ** -7, atol=1e-2)


def test_attention_rows_do_not_depend_on_chunks_or_cache_order():
    """bf16 attention rows: equal bits under any chunking or schedule, and
    decode over a cache (padded, or a rotated ring) = prefill's row."""
    q, k, v = (_bf16(a) for a in _qkv(sq=128, sk=128))
    outs = [TA.flash_attention(q, k, v, logit_cap=50.0, q_chunk=qc,
                               k_chunk=kc, schedule=sched)
            for qc, kc, sched in ((128, 128, "masked"), (32, 32, "masked"),
                                  (64, 64, "banded"), (96, 96, "masked"))]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    last = outs[0][:, -1:]
    pad = torch.zeros((2, 40, 2, 32), dtype=torch.bfloat16)
    valid = torch.arange(168)[None, :].expand(2, 168) < 128
    dec = TA.decode_attention(q[:, -1:], torch.cat([k, pad], 1),
                              torch.cat([v, pad], 1), valid, logit_cap=50.0)
    assert torch.equal(dec, last)
    ring = TA.decode_attention(q[:, -1:], k.roll(37, 1), v.roll(37, 1),
                               torch.ones((2, 128), dtype=torch.bool),
                               logit_cap=50.0)
    assert torch.equal(ring, last)


# ------------------------------------------- model against the reference

def _ref_run(cfg, params, toks):
    """Reference prefill of ``toks[:, :P0]`` then STEPS teacher-forced
    decode steps: the list of last-position logits."""
    model = r_build(cfg)
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t},
                                                 s_cap=S_CAP))
    decode = jax.jit(model.decode_step)
    caches, logits = prefill(params, jnp.asarray(toks[:, :P0]))
    out = [np.asarray(logits, np.float32)]
    for j in range(STEPS):
        caches, logits = decode(params, caches, jnp.asarray(toks[:, P0 + j]),
                                jnp.full((B,), P0 + j, jnp.int32))
        out.append(np.asarray(logits, np.float32))
    return out


def _port_run(model, toks):
    caches, logits = model.prefill({"tokens": torch.from_numpy(
        toks[:, :P0])}, s_cap=S_CAP)
    out = [logits.float().numpy()]
    for j in range(STEPS):
        caches, logits = model.decode_step(
            caches, torch.from_numpy(toks[:, P0 + j]).long(),
            torch.full((B,), P0 + j, dtype=torch.long))
        out.append(logits.float().numpy())
    return out


@pytest.mark.parametrize("arch,kv_dtype", [(a, "bf16") for a in DENSE]
                         + [("qwen3-32b", "int8"), ("gemma2-9b", "int8")])
def test_prefill_and_decode_logits_match_reference(arch, kv_dtype):
    """gemma3's smoke window is 64: decoding at 64-66 wraps its rings."""
    rcfg = RCFG.get_config(arch, smoke=True, kv_cache_dtype=kv_dtype)
    params = ref_params(rcfg)
    toks = tokens(rcfg.vocab_size, P0 + STEPS)
    port = port_model(arch, params, kv_cache_dtype=kv_dtype)
    tol = INT8_TOL if kv_dtype == "int8" else TOL[arch]
    for step, (got, want) in enumerate(zip(_port_run(port, toks),
                                           _ref_run(rcfg, params, toks))):
        assert got.shape == want.shape == (B, rcfg.padded_vocab)
        assert rel_err(got, want) < tol, (arch, step)


@pytest.mark.parametrize("arch,kv_dtype", [(a, "bf16") for a in DENSE]
                         + [("qwen3-32b", "int8")])
def test_port_decode_matches_port_prefill(arch, kv_dtype):
    """Mirror of tests/test_decode_consistency.py: incremental decode ==
    a fresh prefill over the extended sequence."""
    port = port_model(arch, ref_params(RCFG.get_config(arch, smoke=True)),
                      kv_cache_dtype=kv_dtype)
    tol = INT8_TOL if kv_dtype == "int8" else TOL[arch]
    toks = torch.from_numpy(tokens(port.cfg.vocab_size, P0 + STEPS))
    caches, _ = port.prefill({"tokens": toks[:, :P0]}, s_cap=S_CAP)
    for j in range(STEPS):
        caches, dec = port.decode_step(caches, toks[:, P0 + j].long(),
                                       torch.full((B,), P0 + j,
                                                  dtype=torch.long))
        _, ref = port.prefill({"tokens": toks[:, :P0 + j + 1]},
                              s_cap=S_CAP)
        assert rel_err(dec.float().numpy(), ref.float().numpy()) < tol, j


def test_int8_cache_argmax_agrees_with_bf16():
    """The reference's gate: argmax agreement >= 0.5, here on decode
    steps (prefill reads no cache)."""
    params = ref_params(RCFG.get_config("qwen3-32b", smoke=True))
    toks = tokens(512, P0 + STEPS)
    runs = [_port_run(port_model("qwen3-32b", params, kv_cache_dtype=d),
                      toks) for d in ("int8", "bf16")]
    agree = np.mean([np.argmax(a, -1) == np.argmax(b, -1)
                     for a, b in zip(*runs)])
    assert agree >= 0.5, agree


def test_decode_drops_writes_past_the_cache():
    """A global layer's slot is pos: past the cache the write is dropped
    (as JAX drops out-of-range scatter updates), the other rows land."""
    cfg = TCFG.get_config("qwen3-32b", smoke=True)
    cache = {"k": torch.zeros(3, 8, 2, 4, dtype=torch.bfloat16),
             "v": torch.zeros(3, 8, 2, 4, dtype=torch.bfloat16)}
    k = torch.ones(3, 1, 2, 4, dtype=torch.bfloat16)
    pos = torch.tensor([3, 8, 11])
    valid = TT._decode_write(cache, "global", pos, k, 2 * k, int8=False)
    assert valid.all(dim=1).tolist() == [False, True, True]
    assert cache["k"][0, 3].eq(1).all() and cache["v"][0, 3].eq(2).all()
    assert cache["k"][0].count_nonzero() == 8
    assert cache["k"][1:].count_nonzero() == 0
    rcache = {n: jnp.zeros((3, 8, 2, 4), jnp.bfloat16) for n in "kv"}
    rnew = rcache["k"].at[jnp.arange(3), jnp.asarray(pos)].set(
        jnp.ones((3, 2, 4), jnp.bfloat16))
    np.testing.assert_array_equal(cache["k"].float().numpy(),
                                  np.asarray(rnew, np.float32))
    assert cfg.family == "dense"


def test_gemma2_full_width_two_layers_matches_reference():
    """gemma2-9b's widths (d_model 3584, 16/8 heads of 256, d_ff 14336)
    at 2 layers and vocab 512."""
    over = dict(n_layers=2, vocab_size=512)
    rcfg = RCFG.get_config("gemma2-9b", **over)
    tcfg = TCFG.get_config("gemma2-9b", **over)
    params = ref_params(rcfg)
    port = build_model(tcfg, "cpu")
    port.load_state_dict(params_from_numpy(tcfg, as_numpy(params, bits=True),
                                           "cpu"), assign=True)
    toks = tokens(512, 16 + 2)
    model = r_build(rcfg)
    caches, ref = jax.jit(lambda p, t: model.prefill(
        p, {"tokens": t}, s_cap=24))(params, jnp.asarray(toks[:, :16]))
    tc, got = port.prefill({"tokens": torch.from_numpy(toks[:, :16])},
                           s_cap=24)
    assert rel_err(got.float().numpy(), ref) < 0.1
    decode = jax.jit(model.decode_step)
    for j in range(2):
        caches, ref = decode(params, caches, jnp.asarray(toks[:, 16 + j]),
                             jnp.full((B,), 16 + j, jnp.int32))
        tc, got = port.decode_step(tc, torch.from_numpy(toks[:, 16 + j])
                                   .long(), torch.full((B,), 16 + j))
        assert rel_err(got.float().numpy(), ref) < 0.1, j
