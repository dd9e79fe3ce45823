"""Model API: one ``nn.Module`` per architecture, on an explicit device.

  model = build_model(cfg)                      # the card; device="cpu"
  model.init(torch.Generator(model.device).manual_seed(0))
  caches, logits = model.prefill({"tokens": tokens}, s_cap)
  caches, logits = model.decode_step(caches, token, pos)

The parameters live in the module under the JAX package's leaf names
(``embed``, ``final_norm``, ``unembed``, and a layer's ``attn.{norm, wq,
wk, wv, wo, q_norm, k_norm}`` and ``mlp.{norm, w_gate, w_up, w_down}``),
one submodule a layer in the order the stack runs.  They are for
serving: no gradient is kept.  The dense family is ported; the others
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import base, transformer as tfm
from ..configs.base import ArchConfig
from ..device import resolve_device

_NOT_PORTED = ("{} is not ported yet (ROADMAP queue 1: "
               "models/{{moe,ssm,hybrid,encoder,vlm}})")


def _gemma_like(cfg: ArchConfig) -> bool:
    return cfg.local_per_global is not None or cfg.final_logit_cap is not None


class _Block(nn.Module):
    """A template dict's leaves as parameters (nested dicts as blocks);
    ``specs`` keeps each parameter's ``Param`` for :meth:`Model.init`."""

    def __init__(self, template: dict, device):
        super().__init__()
        self.specs = {}
        for name, sub in template.items():
            if base.is_param(sub):
                self.specs[name] = sub
                self.register_parameter(name, nn.Parameter(
                    torch.empty(sub.shape, dtype=sub.dtype, device=device),
                    requires_grad=False))
            else:
                self.add_module(name, _Block(sub, device))


class _Layer(_Block):
    def __init__(self, cfg: ArchConfig, kind: str, device):
        super().__init__(tfm.layer_template(cfg), device)
        self.kind = kind


class Model(_Block):
    """A dense decoder on ``device`` (uninitialised until :meth:`init` or
    ``load_state_dict``)."""

    def __init__(self, cfg: ArchConfig, device):
        if cfg.family != "dense":
            raise NotImplementedError(_NOT_PORTED.format(
                f"the {cfg.family} family"))
        tpl = tfm.lm_templates(cfg)
        super().__init__({k: tpl[k] for k in ("embed", "final_norm",
                                              "unembed") if k in tpl},
                         device)
        self.cfg = cfg
        self.device = device
        self.layers = nn.ModuleList(
            _Layer(cfg, kind, device) for kind in tfm.layer_kinds(cfg))

    # ---------------- params ----------------
    def template(self):
        """The JAX package's template tree (groups and tail stacked)."""
        return tfm.lm_templates(self.cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Seeded random init with the reference's initializers, drawn
        from ``generator`` (which must lie on the model's device)."""
        for block in self.modules():
            for name, spec in getattr(block, "specs", {}).items():
                base.initialize_(getattr(block, name), spec, generator)
        return self

    def param_count(self) -> int:
        return base.param_count(self.template())

    # ---------------- steps ----------------
    @torch.no_grad()
    def prefill(self, batch, s_cap=None):
        """``batch["tokens"]`` (B, S) -> (caches, last logits (B, V))."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        return tfm.lm_prefill(self, tokens, self.cfg, s_cap,
                              embed_scale=_gemma_like(self.cfg))

    @torch.no_grad()
    def decode_step(self, caches, token, pos):
        """token, pos: (B,) ints.  Returns (caches, logits (B, V)); the
        caches are updated in place."""
        return tfm.lm_decode_step(self, caches, token, pos, self.cfg,
                                  embed_scale=_gemma_like(self.cfg))

    def cache_spec(self, batch: int, s_cap: int) -> list:
        """One ``{name: TensorSpec}`` a layer, in layer order."""
        return tfm.lm_cache_spec(self.cfg, batch, s_cap)

    def train_loss(self, *args, **kwargs):
        raise NotImplementedError(
            "train_loss is not ported yet (ROADMAP queue 1: the training "
            "stack, with cross_entropy_chunked)")


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device``: the card unless ``"cpu"``."""
    return Model(cfg, resolve_device(device))


def _to_bf16(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:          # bf16 bits
        return torch.tensor(arr.view(np.int16)).view(torch.bfloat16).to(
            device)
    if arr.dtype != np.float32:
        raise TypeError(f"expected float32 or uint16 (bf16 bits), got "
                        f"{arr.dtype}")
    return torch.tensor(arr, dtype=torch.bfloat16, device=device)


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> dict:
    """The JAX package's parameter tree, as numpy arrays -> a state dict
    of this package's :class:`Model` (``model.load_state_dict(...)``).

    Leaves are float32 (a bf16 value round-trips through float32
    exactly) or uint16 bit views of bf16.  The scan axes are unstacked:
    ``groups/local[g, i]``, ``groups/global[g]`` and ``tail[i]`` become
    the layers in the order the stack runs.
    """
    device = resolve_device(device)
    k_local, has_global, n_groups, n_tail = tfm.group_pattern(cfg)
    out = {k: _to_bf16(tree[k], device)
           for k in ("embed", "final_norm", "unembed") if k in tree}
    layers = []
    for g in range(n_groups):
        for i in range(k_local):
            layers.append((tree["groups"]["local"], (g, i)))
        if has_global:
            layers.append((tree["groups"]["global"], (g,)))
    layers += [(tree["tail"], (i,)) for i in range(n_tail)]
    for n, (sub, idx) in enumerate(layers):
        for path, arr in base.leaves(sub):
            out[".".join(("layers", str(n)) + path)] = \
                _to_bf16(arr[idx], device)
    return out

