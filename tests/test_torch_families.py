"""The port's other model families -- moe (dbrx-132b, llama4-scout),
ssm (mamba2-370m), hybrid (zamba2-1.2b), encoder (hubert-xlarge) and vlm
(paligemma-3b) -- against the JAX package's, on the CPU.

Both packages get the same parameters (numpy draws in each leaf's dtype,
``params_from_numpy``) and the same inputs at smoke size.  Logits are
compared as max|d| / std(reference logits) within ``TOL``, the
reference's own decode-consistency tolerances where it has one
(``tests/test_decode_consistency.py``: dbrx 0.08, mamba2 0.05, zamba2
0.12), 0.08 for llama4-scout (MoE, as dbrx), 0.05 for hubert (no decode)
and 0.1 for paligemma (tied embedding at std 0.02: one bf16 ulp of a
logit is 2-3% of the logits' std, and the port's decode attention rounds
P, not the normalized softmax, as the reference's does).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.models import build_model as r_build
from repro.models import hybrid as RH
from repro_torch import configs as TCFG
from repro_torch.models import hybrid as TH

from test_torch_models import (B, DTYPES, P0, S_CAP, STEPS, _port_run,
                               _ref_run, port_model, ref_params, rel_err,
                               tokens)

TOL = {"dbrx-132b": 0.08, "llama4-scout-17b-a16e": 0.08,
       "mamba2-370m": 0.05, "zamba2-1.2b": 0.12, "hubert-xlarge": 0.05,
       "paligemma-3b": 0.1}
TOKEN_FAMILIES = ("dbrx-132b", "llama4-scout-17b-a16e", "mamba2-370m",
                  "zamba2-1.2b")


@pytest.mark.parametrize("arch", TOKEN_FAMILIES)
def test_prefill_and_decode_logits_match_reference(arch):
    """A 64-token prefill (expert choice in the MoE layers: 128 tokens >
    4 x 4 experts; two 32-token chunks in the SSD) and 3 teacher-forced
    decode steps (token choice; the recurrent SSD step)."""
    rcfg = RCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    toks = tokens(rcfg.vocab_size, P0 + STEPS)
    port = port_model(arch, params)
    for step, (got, want) in enumerate(zip(_port_run(port, toks),
                                           _ref_run(rcfg, params, toks))):
        assert got.shape == want.shape == (B, rcfg.padded_vocab)
        assert rel_err(got, want) < TOL[arch], (arch, step)


def stacked(caches, cfg):
    """The port's per-application cache list as the reference's stacked
    tree (``hybrid_cache_spec``: groups/{shared, mamba[i]}, tail[i])."""
    every, n_groups, n_tail = TH.pattern(cfg)
    apps = iter(caches)
    groups = []
    for _ in range(n_groups):
        group = {"shared": next(apps)} if cfg.shared_attn_every else {}
        group["mamba"] = [next(apps) for _ in range(every)]
        groups.append(group)
    tree = {"groups": groups, "tail": [next(apps) for _ in range(n_tail)]}

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        if isinstance(items[0], list):
            return stack([stack(it) for it in items])
        return np.stack(items)
    out = {"groups": stack(tree["groups"])}
    if n_tail:
        out["tail"] = stack(tree["tail"])
    return out


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_cache_spec_maps_to_the_reference_tree(arch):
    """zamba2's smoke stack: 2 groups of (shared attention, 2 Mamba
    layers) and a tail of 1; mamba2's: 4 groups of 1 Mamba layer."""
    rcfg = RCFG.get_config(arch, smoke=True)
    tcfg = TCFG.get_config(arch, smoke=True)
    spec = TH.hybrid_cache_spec(tcfg, 3, 96)
    shapes = stacked([{k: np.empty(s.shape, DTYPES[s.dtype])
                       for k, s in app.items()} for app in spec], tcfg)
    want = RH.hybrid_cache_spec(rcfg, 3, 96)
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), shapes)
    assert got == jax.tree_util.tree_map(lambda s: (s.shape, s.dtype), want)
    assert len(spec) == {"mamba2-370m": 4, "zamba2-1.2b": 7}[arch]


def test_hybrid_prefill_caches_match_reference():
    """zamba2's prefill caches, mapped to the reference's tree: the
    shared block's keys and values per application, each Mamba layer's
    pre-conv rows and float32 state."""
    arch = "zamba2-1.2b"
    rcfg = RCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    toks = tokens(rcfg.vocab_size, P0)
    rcaches, _ = r_build(rcfg).prefill(params, {"tokens": jnp.asarray(toks)},
                                       s_cap=S_CAP)
    tcaches, _ = port_model(arch, params).prefill(
        {"tokens": torch.from_numpy(toks)}, s_cap=S_CAP)
    got = stacked([{k: v.float().numpy() for k, v in app.items()}
                   for app in tcaches], TCFG.get_config(arch, smoke=True))
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(rcaches)):
        assert g.shape == w.shape, path
        assert rel_err(g, w) < TOL[arch], path


def test_encoder_forward_matches_reference():
    """hubert-xlarge: 64 frames of width 512 through 4 bidirectional
    layers, unit logits at every frame."""
    arch = "hubert-xlarge"
    rcfg = RCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    frames = np.random.default_rng(6).standard_normal((B, 64, 512))
    fb = jnp.asarray(frames, jnp.bfloat16)
    _, want = jax.jit(lambda p, f: r_build(rcfg).prefill(
        p, {"frames": f}))(params, fb)
    port = port_model(arch, params)
    caches, got = port.prefill({"frames": torch.from_numpy(
        np.asarray(fb, np.float32)).to(torch.bfloat16)})
    assert caches is None
    assert got.shape == want.shape == (B, 64, rcfg.padded_vocab)
    assert rel_err(got.float().numpy(), want) < TOL[arch]
    with pytest.raises(ValueError, match="no decode step"):
        port.decode_step(None, torch.zeros(B, dtype=torch.long),
                         torch.zeros(B, dtype=torch.long))
    with pytest.raises(ValueError, match="no cache"):
        port.cache_spec(B, 16)


def test_vlm_prefill_and_decode_match_reference():
    """paligemma-3b: 16 image tokens of width 64 under the prefix-LM
    mask, 64 text tokens, then 3 teacher-forced decode steps."""
    arch = "paligemma-3b"
    rcfg = RCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    nv, s_cap = rcfg.n_vis_tokens, S_CAP + rcfg.n_vis_tokens
    img = np.random.default_rng(8).standard_normal((B, nv, rcfg.d_vis))
    ib = jnp.asarray(img, jnp.bfloat16)
    it = torch.from_numpy(np.asarray(ib, np.float32)).to(torch.bfloat16)
    toks = tokens(rcfg.vocab_size, P0 + STEPS)
    model = r_build(rcfg)
    rc, want = jax.jit(lambda p, i, t: model.prefill(
        p, {"image_embeds": i, "tokens": t}, s_cap=s_cap))(
        params, ib, jnp.asarray(toks[:, :P0]))
    port = port_model(arch, params)
    tc, got = port.prefill({"image_embeds": it,
                            "tokens": torch.from_numpy(toks[:, :P0])},
                           s_cap=s_cap)
    assert rel_err(got.float().numpy(), want) < TOL[arch]
    decode = jax.jit(model.decode_step)
    for j in range(STEPS):
        pos = nv + P0 + j
        rc, want = decode(params, rc, jnp.asarray(toks[:, P0 + j]),
                          jnp.full((B,), pos, jnp.int32))
        tc, got = port.decode_step(tc, torch.from_numpy(toks[:, P0 + j])
                                   .long(), torch.full((B,), pos))
        assert rel_err(got.float().numpy(), want) < TOL[arch], j


@pytest.mark.parametrize("arch,b,p0", [
    ("dbrx-132b", B, P0), ("mamba2-370m", B, P0), ("zamba2-1.2b", B, P0),
    ("llama4-scout-17b-a16e", 1, 12)])
def test_port_decode_matches_port_prefill(arch, b, p0):
    """Mirror of tests/test_decode_consistency.py: incremental decode ==
    a fresh prefill over the extended sequence (SSM: the recurrent step
    against the chunked scan).  dbrx's smoke top-4 of 4 experts routes
    the same under expert choice (2 x 65-67 tokens) and token choice;
    llama4-scout's top-1 does not (0.23 of the logits' std here, 0.34 in
    the reference's own run), so it runs one sequence of 12-15 tokens,
    where both sides take token choice (<= 4 x 4 experts)."""
    port = port_model(arch, ref_params(RCFG.get_config(arch, smoke=True)))
    toks = torch.from_numpy(tokens(port.cfg.vocab_size, p0 + STEPS)[:b])
    caches, _ = port.prefill({"tokens": toks[:, :p0]}, s_cap=S_CAP)
    for j in range(STEPS):
        caches, dec = port.decode_step(caches, toks[:, p0 + j].long(),
                                       torch.full((b,), p0 + j,
                                                  dtype=torch.long))
        _, ref = port.prefill({"tokens": toks[:, :p0 + j + 1]},
                              s_cap=S_CAP)
        assert rel_err(dec.float().numpy(), ref.float().numpy()) < \
            TOL[arch], j
