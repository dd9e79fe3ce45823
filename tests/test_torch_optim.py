"""The port's optimizers (``repro_torch.optim.{adamw,adafactor}``)
against the JAX package's, on the CPU: one update on the same trees.

The trees are smoke models' parameters (bf16 leaves, and the float32
MoE router and SSM scalars), with gradients and optimizer state drawn
with numpy; the port holds them unstacked by state-dict name and maps
them to the reference's stacked leaves through ``param_layout``.

Tolerances: a bf16 parameter within 1 bf16 ulp of the reference's; a
float32 parameter, and the float32 state, within 1e-6 of the leaf's
largest magnitude.  The port's ``global_norm`` sums the unstacked
leaves in another order (and Adafactor's means reduce in torch's), which
moves the clipping scale by an ulp: where the update cancels a bf16
parameter to a few 1e-7 that moves the result by more than one of its
tiny ulps, so there the bf16 parameter is held to the float32 bound.
"""
import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import configs as RCFG
from repro.optim import adafactor as RAF
from repro.optim import adamw as RADAM
from repro_torch import configs as TCFG
from repro_torch import optim as TOPT
from repro_torch.models import api as TAPI
from repro_torch.optim import adafactor as TAF
from repro_torch.optim import adamw as TADAM

from test_torch_models import ref_params

STATE_RTOL = 1e-6


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


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().to(torch.float32).numpy()


def leaf_at(tree, path, idx=()):
    for key in path:
        tree = tree[key]
    return tree[idx] if idx else tree


def random_like(tree, rng, scale=1.0, positive=False):
    """numpy draws in each leaf's shape and dtype (bf16 through jnp)."""
    def one(a):
        x = rng.standard_normal(a.shape).astype(np.float32) * scale
        return jnp.asarray(np.abs(x) if positive else x, a.dtype)
    return jax.tree_util.tree_map(one, tree)


def port_dict(tcfg, tree, dtype=None):
    """The reference's stacked tree -> {state-dict name: tensor} (each
    leaf's own dtype, or ``dtype``)."""
    out = {}
    for name, path, idx, _ in TAPI.param_layout(tcfg):
        a = np.asarray(leaf_at(tree, path, idx))
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        out[name] = t.to(dtype or (torch.bfloat16 if a.dtype == jnp.bfloat16
                                   else torch.float32))
    return out


def assert_params_close(tcfg, got, want_tree):
    for name, path, idx, _ in TAPI.param_layout(tcfg):
        want = np.asarray(leaf_at(want_tree, path, idx))
        g = got[name]
        if g.dtype == torch.bfloat16:
            assert want.dtype == jnp.bfloat16, name
            a = g.view(torch.int16).numpy().astype(np.int32)
            b = want.view(np.int16).astype(np.int32)
            ordered = [np.where(x < 0, -32768 - x, x) for x in (a, b)]
            ulps = np.abs(ordered[0] - ordered[1])
            w = want.astype(np.float32)
            cancelled = np.abs(g.float().numpy() - w) \
                <= STATE_RTOL * np.abs(w).max()
            assert ((ulps <= 1) | cancelled).all(), name
        else:
            assert_state_close(g, want, name)


def assert_state_close(got, want, name):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    atol = STATE_RTOL * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


# ------------------------------------------------------------------ AdamW

@pytest.mark.parametrize("arch", ["qwen3-32b", "mamba2-370m",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("schedule", ["cosine", "constant", "linear"])
@pytest.mark.parametrize("clip_norm, step", [(1.0, 5), (None, 5),
                                             (1e9, 0)])
def test_adamw_update_matches_reference(arch, schedule, clip_norm, step):
    """One update from a drawn state at ``step`` (5: past warmup, into
    the decay; 0: the first warmup step): bf16 leaves only (qwen3), the
    float32 SSM scalars and MoE router, the decay mask, clipping (active
    at 1.0, off at None, inactive at 1e9)."""
    rcfg = RCFG.get_config(arch, smoke=True)
    tcfg = TCFG.get_config(arch, smoke=True)
    rng = np.random.default_rng(zlib.crc32(
        f"{arch}{schedule}{step}".encode()))
    params = ref_params(rcfg)
    grads = random_like(params, rng, 0.05)
    m = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                               random_like(params, rng, 0.01))
    # v >= m^2, as Adam's moments keep it (|update| stays near 1)
    v = jax.tree_util.tree_map(
        lambda a, r: a * a * (1 + jnp.asarray(r, jnp.float32)) + 1e-10, m,
        random_like(m, rng, positive=True))
    state = {"step": jnp.asarray(step, jnp.int32), "m": m, "v": v}
    kw = dict(lr=1e-2, schedule=schedule, warmup_steps=2, total_steps=20,
              clip_norm=clip_norm)
    want_p, want_s, want_stats = RADAM.apply_updates(
        params, grads, state, RADAM.AdamWConfig(**kw))

    p = port_dict(tcfg, params)
    tstate = {"step": torch.tensor(step, dtype=torch.int32),
              "m": port_dict(tcfg, state["m"], torch.float32),
              "v": port_dict(tcfg, state["v"], torch.float32)}
    stats = TOPT.apply_updates(p, port_dict(tcfg, grads), tstate,
                               TOPT.AdamWConfig(**kw))
    assert int(tstate["step"]) == int(want_s["step"]) == step + 1
    assert float(stats["lr"]) == float(want_stats["lr"])
    # float32 sums of squares in another order (XLA's reduction against
    # torch's, leaf by leaf unstacked): a few parts in a million
    assert abs(float(stats["grad_norm"]) - float(want_stats["grad_norm"])) \
        <= 1e-5 * float(want_stats["grad_norm"])
    assert_params_close(tcfg, p, want_p)
    for key in ("m", "v"):
        for name, path, idx, _ in TAPI.param_layout(tcfg):
            assert_state_close(tstate[key][name],
                               leaf_at(want_s[key], path, idx), name)


@pytest.mark.parametrize("arch", RCFG.ARCH_NAMES)
def test_decay_mask_is_the_reference_set(arch):
    """The substring test on a state-dict name decays the same leaves as
    the reference's on the leaf's path (``layers.3.attn.norm`` against
    ``groups/global/attn/norm``)."""
    tcfg = TCFG.get_config(arch, smoke=True)
    got = {name: TADAM.decays(name)
           for name, _, _, _ in TAPI.param_layout(tcfg)}
    want = {name: RADAM._decay_mask(path)
            for name, path, _, _ in TAPI.param_layout(tcfg)}
    assert got == want
    assert any(got.values()) and not all(got.values())


@pytest.mark.parametrize("schedule", ["cosine", "constant", "linear"])
def test_schedules_match_reference(schedule):
    cfg = dict(lr=3e-4, schedule=schedule, warmup_steps=7, total_steps=50,
               min_lr_ratio=0.2)
    for step in (0, 1, 6, 7, 8, 30, 49, 50, 80):
        want = RADAM.schedule_lr(RADAM.AdamWConfig(**cfg),
                                 jnp.asarray(step, jnp.int32))
        got = TADAM.schedule_lr(TADAM.AdamWConfig(**cfg), step)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-7 * float(want) + 1e-12


def test_init_state_and_global_norm():
    params = {"w": torch.ones(3, 4, dtype=torch.bfloat16),
              "b": torch.full((5,), 2.0)}
    st = TOPT.init_state(params)
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    assert all(t.dtype == torch.float32 and not t.any()
               for key in ("m", "v") for t in st[key].values())
    assert float(TOPT.global_norm(params)) == pytest.approx(
        float(np.sqrt(12 + 20)))


# ------------------------------------------------------------------ Adafactor

#: (arch, overrides, {reference leaf: factored}) -- the stacked shapes
#: decide: a (4, 128) stacked norm is factored, (1, 128) and (2, 1, 128)
#: are not, an unstacked (128,) never is
ADAFACTOR_CASES = [
    ("qwen3-32b", {}, {"groups/global/attn/norm": True,          # (4, 128)
                       "final_norm": False}),
    ("qwen3-32b", {"n_layers": 1}, {"groups/global/attn/norm": False}),
    ("gemma3-1b", {}, {"groups/global/attn/norm": False,         # (1, 128)
                       "groups/local/attn/norm": True,           # (1, 5, 128)
                       "tail/attn/q_norm": True}),               # (2, 32)
    ("gemma2-9b", {}, {"groups/local/attn/norm": False,          # (2, 1, 128)
                       "groups/global/attn/norm": True}),        # (2, 128)
    ("zamba2-1.2b", {}, {"groups/mamba/A_log": True,             # (2, 2, 4)
                         "tail/A_log": False,                    # (1, 4)
                         "shared_attn/attn/norm": False}),       # (128,)
]


@pytest.mark.parametrize("arch, over, factored", ADAFACTOR_CASES)
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_update_matches_reference(arch, over, factored,
                                            weight_decay):
    """One update from a drawn state at step 3: stacked leaves of every
    kind, at >= 2 layers and at 1; the state in the reference's stacked
    shapes."""
    rcfg = RCFG.get_config(arch, smoke=True, **over)
    tcfg = TCFG.get_config(arch, smoke=True, **over)
    leaves = TAPI.stacked_layout(tcfg)
    rng = np.random.default_rng(len(arch) + len(over))
    params = ref_params(rcfg)
    grads = random_like(params, rng, 0.05)
    cfg = dict(lr=1e-2, weight_decay=weight_decay)
    ref_state = RAF.init_state(params)
    ref_state = {"step": jnp.asarray(3, jnp.int32),
                 "v": random_like(ref_state["v"], rng, 1e-3, positive=True)}
    want_p, want_s, _ = RAF.apply_updates(params, grads, ref_state,
                                          RAF.AdafactorConfig(**cfg))

    p = port_dict(tcfg, params)
    state = TAF.init_state(p, leaves=leaves)
    for path in leaves:
        key = "/".join(path)
        want = leaf_at(ref_state["v"], path)
        assert set(state["v"][key]) == set(want)
        for k, t in state["v"][key].items():
            assert tuple(t.shape) == want[k].shape, (key, k)
            t.copy_(torch.from_numpy(np.array(want[k])))
        if key in factored:
            assert ("vr" in want) == factored[key], key
    state["step"] = torch.tensor(3, dtype=torch.int32)
    TAF.apply_updates(p, port_dict(tcfg, grads), state,
                      TAF.AdafactorConfig(**cfg), leaves=leaves)
    assert int(state["step"]) == 4
    assert_params_close(tcfg, p, want_p)
    for path in leaves:
        for k, t in state["v"]["/".join(path)].items():
            assert_state_close(t, leaf_at(want_s["v"], path)[k],
                               "/".join(path) + ":" + k)


@pytest.mark.parametrize("arch", ["qwen3-32b", "gemma2-9b", "zamba2-1.2b"])
def test_adafactor_state_bytes_match_reference(arch):
    rcfg = RCFG.get_config(arch, smoke=True)
    tcfg = TCFG.get_config(arch, smoke=True)
    params = ref_params(rcfg)
    assert TAF.state_bytes(port_dict(tcfg, params),
                           TAPI.stacked_layout(tcfg)) == \
        RAF.state_bytes(params)


def test_adafactor_without_layout_is_per_parameter():
    """With no ``leaves`` each parameter is its own leaf."""
    p = {"w": torch.ones(4, 3), "b": torch.ones(3)}
    st = TAF.init_state(p)
    assert set(st["v"]["w"]) == {"vr", "vc"} and set(st["v"]["b"]) == {"v"}
    TAF.apply_updates(p, {"w": torch.ones(4, 3), "b": torch.ones(3)}, st,
                      TAF.AdafactorConfig(lr=0.5))
    assert torch.allclose(p["w"], torch.full((4, 3), 0.5))
    assert torch.allclose(p["b"], torch.full((3,), 0.5))
