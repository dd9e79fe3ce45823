"""Model API: one ``nn.Module`` per architecture, on an explicit device.

  model = build_model(cfg)                      # the card; device="cpu"
  model.init(torch.Generator(model.device).manual_seed(0))
  caches, logits = model.prefill({"tokens": tokens}, s_cap)
  caches, logits = model.decode_step(caches, token, pos)
  batch  = model.train_input_specs(shape) / prefill_input_specs(shape)
  model.requires_grad_(True)
  loss = model.train_loss({"tokens": t, "labels": l, "mask": m})

Families: dense | moe (:mod:`.transformer`, :mod:`.moe`), ssm | hybrid
(:mod:`.hybrid`, :mod:`.ssm`), encoder (:mod:`.encoder`: ``prefill``
takes ``{"frames"}`` and returns ``(None, logits (B, T, V))``), vlm
(:mod:`.vlm`: ``{"image_embeds", "tokens"}``).

The parameters live in the module under the JAX package's leaf names:
the template's top-level leaves (``embed``, ``final_norm``, ``unembed``,
``vis_proj``, ``frame_proj``, ``mask_embed``, ``lm_head``), ``layers``
(one submodule a layer in the order the stack runs: attention layers,
or a hybrid's Mamba layers) and a hybrid's one ``shared_attn`` block.
Only the layer and group scan axes are unstacked: an MoE layer's experts
stay one ``(E, d, f)`` parameter.  A leaf keeps its template's dtype
(the MoE ``router`` and the SSM's ``dt_bias``, ``A_log`` and ``D`` are
float32).  They are made with ``requires_grad=False``, so serving
keeps no gradient (``prefill`` and ``decode_step`` also run under
``torch.no_grad``); ``model.requires_grad_(True)`` turns gradients on
for ``train_loss`` (``runtime.make_train_step`` does).  The reference's
stacked trees of parameters, or of anything keyed by parameter name (the
optimizer's moments), come and go through :func:`stack_tree`,
:func:`unstack_tree`, :func:`params_from_numpy` and
:func:`params_to_numpy`.

On a ``torch.distributed`` mesh, :meth:`Model.param_specs` gives each
parameter the reference's spec (its stacked leaf's, less the stack
axes), :meth:`Model.distribute_` turns the parameters into DTensors at
those placements (each rank keeps its chunk of the full, seeded values),
``train_loss(batch, mesh)`` trains on DTensor batches, and
``prefill(batch, s_cap, mesh)`` / ``decode_step(caches, token, pos,
mesh)`` serve on DTensor caches (``init_cache(batch, s_cap, mesh)``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import base, encoder, hybrid, ssm, transformer as tfm, vlm
from .transformer import TensorSpec
from ..configs.base import ArchConfig, ShapeCfg
from ..device import resolve_device


def _gemma_like(cfg: ArchConfig) -> bool:
    return cfg.local_per_global is not None or cfg.final_logit_cap is not None


def template(cfg: ArchConfig) -> dict:
    """The JAX package's template tree of ``cfg`` (scan axes stacked)."""
    f = cfg.family
    if f in ("dense", "moe"):
        return tfm.lm_templates(cfg)
    if f in ("ssm", "hybrid"):
        return hybrid.hybrid_templates(cfg)
    if f == "encoder":
        return encoder.encoder_templates(cfg)
    if f == "vlm":
        return vlm.vlm_templates(cfg)
    raise ValueError(f)


def _layer_sources(cfg: ArchConfig) -> list:
    """(subtree path, index) in the reference's tree of every layer of
    the stack, in the order it runs."""
    if cfg.family in ("ssm", "hybrid"):
        every, n_groups, n_tail = hybrid.pattern(cfg)
        return [(("groups", "mamba"), (g, i)) for g in range(n_groups)
                for i in range(every)] + \
            [(("tail",), (i,)) for i in range(n_tail)]
    if cfg.family == "encoder":
        return [(("layers",), (i,)) for i in range(cfg.n_layers)]
    k_local, has_global, n_groups, n_tail = tfm.group_pattern(cfg)
    out = []
    for g in range(n_groups):
        out += [(("groups", "local"), (g, i)) for i in range(k_local)]
        if has_global:
            out.append((("groups", "global"), (g,)))
    return out + [(("tail",), (i,)) for i in range(n_tail)]


def _layer_template(cfg: ArchConfig) -> dict:
    if cfg.family in ("ssm", "hybrid"):
        return ssm.ssm_template(cfg)
    return tfm.layer_template(cfg)


def param_layout(cfg: ArchConfig) -> list:
    """``(state-dict name, path in the reference's tree, index into that
    leaf, Param)`` of every parameter of :class:`Model`."""
    tpl = template(cfg)
    out = [(k, (k,), (), p) for k, p in tpl.items() if base.is_param(p)]
    layer = _layer_template(cfg)
    for n, (path, idx) in enumerate(_layer_sources(cfg)):
        out += [(".".join(("layers", str(n)) + sub), path + sub, idx, p)
                for sub, p in base.leaves(layer)]
    if "shared_attn" in tpl:
        out += [(".".join(("shared_attn",) + sub), ("shared_attn",) + sub,
                 (), p) for sub, p in base.leaves(tpl["shared_attn"])]
    return out


def param_specs(cfg: ArchConfig, mesh) -> dict:
    """``{state-dict name: P}``: the reference's ``spec_tree`` entry of
    each parameter's stacked leaf, less the stack axes (which resolve
    to ``None``)."""
    return {name: base.resolve_logical(p.logical, p.shape, mesh)
            for name, _, _, p in param_layout(cfg)}


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
    """A model of ``cfg`` on ``device`` (uninitialised until :meth:`init`
    or ``load_state_dict``)."""

    def __init__(self, cfg: ArchConfig, device):
        tpl = template(cfg)
        super().__init__({k: p for k, p in tpl.items() if base.is_param(p)},
                         device)
        self.cfg = cfg
        self.device = device
        self.mesh = None                 # set by distribute_
        if cfg.family in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(
                _Block(ssm.ssm_template(cfg), device)
                for _ in _layer_sources(cfg))
            if "shared_attn" in tpl:
                self.shared_attn = _Layer(cfg, "global", device)
        elif cfg.family == "encoder":
            self.layers = nn.ModuleList(
                _Layer(cfg, "global", device) for _ in range(cfg.n_layers))
        else:
            self.layers = nn.ModuleList(
                _Layer(cfg, kind, device) for kind in tfm.layer_kinds(cfg))

    # ---------------- params ----------------
    def template(self):
        """The JAX package's template tree (scan axes stacked)."""
        return template(self.cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Seeded random init with the reference's initializers, drawn
        from ``generator`` (which must lie on the model's device), one
        parameter at a time (before :meth:`distribute_`)."""
        for block in self.modules():
            for name, spec in getattr(block, "specs", {}).items():
                base.initialize_(getattr(block, name), spec, generator)
        return self

    def param_specs(self, mesh) -> dict:
        """:func:`param_specs` of the model's config."""
        return param_specs(self.cfg, mesh)

    @torch.no_grad()
    def distribute_(self, mesh) -> "Model":
        """Every parameter -> a DTensor on ``mesh`` (a ``DeviceMesh`` of
        the model's device type) at :meth:`param_specs`' placements,
        each rank keeping its chunk of the values it holds (the same
        on every rank after a seeded :meth:`init`)."""
        specs = self.param_specs(mesh)
        for name, param in list(self.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner) if owner else self
            module.register_parameter(leaf, nn.Parameter(
                base.distribute(param.data, mesh,
                                base.placements(specs[name], mesh)),
                requires_grad=param.requires_grad))
        self.mesh = mesh
        return self

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict``; into a distributed model each
        rank copies its chunk of the full tensors given."""
        if self.mesh is None:
            return super().load_state_dict(state_dict, strict, assign)
        own = dict(self.named_parameters())
        if strict and set(state_dict) != set(own):
            raise RuntimeError(
                f"state dict keys differ: missing "
                f"{sorted(set(own) - set(state_dict))[:5]}, unexpected "
                f"{sorted(set(state_dict) - set(own))[:5]}")
        with torch.no_grad():
            for name, t in state_dict.items():
                p = own[name]
                p.to_local().copy_(base.local_chunk(
                    t.to(self.device), self.mesh, p.placements))
        return None

    def param_count(self) -> int:
        return base.param_count(self.template())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed experts count top_k/E)."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.family != "moe" or not cfg.n_experts:
            return total
        expert_p = 3 * cfg.d_model * cfg.d_ff_expert * cfg.n_experts \
            * cfg.n_layers
        active = expert_p * cfg.top_k / cfg.n_experts
        return int(total - expert_p + active)

    # ---------------- steps ----------------
    def _on(self, mesh):
        """Refuse a mesh the model is not distributed on."""
        if mesh is not None and self.mesh is not mesh:
            raise ValueError("a step on a mesh the model is not "
                             "distributed on (Model.distribute_)")

    def _input(self, t, mesh):
        """An input leaf on the model's device; on a ``mesh`` a DTensor
        at ``batch_spec``'s placements (a DTensor stays as it is)."""
        if isinstance(t, base.DTensor):
            return t
        t = torch.as_tensor(t, device=self.device)
        if mesh is None:
            return t
        from ..launch.sharding import batch_spec
        return base.distribute(t, mesh, base.placements(
            batch_spec(mesh, t.ndim, t.shape[0]), mesh))

    @torch.no_grad()
    def prefill(self, batch, s_cap=None, mesh=None):
        """``batch["tokens"]`` (B, S) -> (caches, last logits (B, V));
        the encoder takes ``batch["frames"]`` and returns (None, logits
        (B, T, V)); the VLM takes ``image_embeds`` and ``tokens``.  On a
        ``mesh`` (the model distributed on it) the inputs are placed by
        ``batch_spec``, the caches come at ``cache_specs``' placements
        and the logits batch-split over the data axes."""
        self._on(mesh)
        f, cfg = self.cfg.family, self.cfg

        def arg(name):
            return self._input(batch[name], mesh)
        if f in ("dense", "moe"):
            return tfm.lm_prefill(self, arg("tokens"), cfg, s_cap,
                                  embed_scale=_gemma_like(cfg), mesh=mesh)
        if f in ("ssm", "hybrid"):
            return hybrid.lm_prefill(self, arg("tokens"), cfg, s_cap, mesh)
        if f == "encoder":
            return None, encoder.encoder_forward(self, arg("frames"), cfg,
                                                 mesh)
        return vlm.vlm_prefill(self, arg("image_embeds"), arg("tokens"), cfg,
                               s_cap, mesh)

    @torch.no_grad()
    def decode_step(self, caches, token, pos, mesh=None):
        """token, pos: (B,) ints.  Returns (caches, logits (B, V)); the
        caches are updated in place.  On a ``mesh`` the caches are
        :meth:`init_cache`'s DTensors and token, pos are placed by
        ``batch_spec``."""
        self._on(mesh)
        f, cfg = self.cfg.family, self.cfg
        token, pos = self._input(token, mesh), self._input(pos, mesh)
        if f in ("dense", "moe"):
            return tfm.lm_decode_step(self, caches, token, pos, cfg,
                                      embed_scale=_gemma_like(cfg),
                                      mesh=mesh)
        if f in ("ssm", "hybrid"):
            return hybrid.lm_decode_step(self, caches, token, pos, cfg, mesh)
        if f == "vlm":
            return vlm.vlm_decode_step(self, caches, token, pos, cfg, mesh)
        raise ValueError(f"{f} has no decode step")

    def cache_spec(self, batch: int, s_cap: int) -> list:
        """One ``{name: TensorSpec}`` a layer (a hybrid's: an
        application), in the order the stack runs."""
        f = self.cfg.family
        if f in ("dense", "moe", "vlm"):
            return tfm.lm_cache_spec(self.cfg, batch, s_cap)
        if f in ("ssm", "hybrid"):
            return hybrid.hybrid_cache_spec(self.cfg, batch, s_cap)
        raise ValueError(f"{f} has no cache")

    def init_cache(self, batch: int, s_cap: int, mesh=None) -> list:
        """Zeroed caches of :meth:`cache_spec` on the model's device; on
        a ``mesh`` DTensors at ``launch.sharding.cache_specs``'
        placements."""
        return tfm.init_cache(self.cache_spec(batch, s_cap), self.device,
                              mesh)

    # ---------------- abstract inputs (dry run) ----------------
    def abstract_params(self) -> dict:
        """The reference's parameter tree (scan axes stacked) as meta
        tensors of its shapes and dtypes."""
        return base.abstract_params(self.template())

    def train_input_specs(self, shape: ShapeCfg) -> dict:
        """``{name: TensorSpec}`` of a train batch of ``shape``."""
        b, s = shape.global_batch, shape.seq_len
        f, i32 = self.cfg.family, torch.int32
        if f == "encoder":
            return {"frames": TensorSpec((b, s, encoder.D_FRONTEND),
                                         torch.bfloat16),
                    "mask": TensorSpec((b, s), torch.bool),
                    "labels": TensorSpec((b, s), i32)}
        if f == "vlm":
            nv, dv = self.cfg.n_vis_tokens, self.cfg.d_vis
            st = s - nv
            return {"image_embeds": TensorSpec((b, nv, dv), torch.bfloat16),
                    "tokens": TensorSpec((b, st), i32),
                    "labels": TensorSpec((b, st), i32),
                    "mask": TensorSpec((b, st), torch.float32)}
        return {"tokens": TensorSpec((b, s), i32),
                "labels": TensorSpec((b, s), i32),
                "mask": TensorSpec((b, s), torch.float32)}

    def prefill_input_specs(self, shape: ShapeCfg) -> dict:
        """``{name: TensorSpec}`` of a prefill batch of ``shape``."""
        b, s = shape.global_batch, shape.seq_len
        f = self.cfg.family
        if f == "encoder":
            return {"frames": TensorSpec((b, s, encoder.D_FRONTEND),
                                         torch.bfloat16)}
        if f == "vlm":
            nv, dv = self.cfg.n_vis_tokens, self.cfg.d_vis
            return {"image_embeds": TensorSpec((b, nv, dv), torch.bfloat16),
                    "tokens": TensorSpec((b, s - nv), torch.int32)}
        return {"tokens": TensorSpec((b, s), torch.int32)}

    def train_loss(self, batch, mesh=None):
        """Mean cross-entropy of ``batch``: ``tokens``, ``labels`` and
        an optional ``mask`` (the encoder: ``frames``, bool ``mask``,
        ``labels``; the VLM adds ``image_embeds``), as the reference's
        ``Model.train_loss``.  Gradients flow to the parameters that
        require them.  With a ``mesh`` the model is distributed on it
        and the batch leaves are DTensors (``data.device_batch``); the
        loss is then a plain tensor, the same bits on every rank."""
        f, cfg = self.cfg.family, self.cfg
        if mesh is None:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
        elif self.mesh is not mesh:
            raise ValueError("train_loss on a mesh the model is not "
                             "distributed on (Model.distribute_)")
        if f in ("dense", "moe"):
            return tfm.lm_train_loss(self, batch, cfg,
                                     embed_scale=_gemma_like(cfg),
                                     mesh=mesh)
        if f in ("ssm", "hybrid"):
            return hybrid.lm_train_loss(self, batch, cfg, mesh)
        if f == "encoder":
            return encoder.encoder_train_loss(self, batch, cfg, mesh)
        return vlm.vlm_train_loss(self, batch, cfg, mesh)


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device``: the card unless ``"cpu"``."""
    return Model(cfg, resolve_device(device))


def _leaf(arr, dtype, device) -> torch.Tensor:
    """One leaf as ``dtype``: a float32 leaf from float32 (bit for bit),
    a bf16 leaf from float32 (exact for bf16 values) or uint16 bits."""
    arr = np.asarray(arr)
    if dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.tensor(arr.view(np.int16)).view(torch.bfloat16).to(
            device)
    if arr.dtype != np.float32:
        want = ("float32 or uint16 (bf16 bits)" if dtype == torch.bfloat16
                else "float32")
        raise TypeError(f"expected {want} for a {dtype} leaf, got "
                        f"{arr.dtype}")
    return torch.tensor(arr, dtype=dtype, device=device)


def stacked_layout(cfg: ArchConfig) -> dict:
    """``{reference leaf path: (stacked shape, [(state-dict name,
    index)])}`` in the reference's flatten order (dict keys sorted): the
    state-dict entries each leaf of the reference's tree stacks."""
    tpl = template(cfg)
    out = {}
    for name, path, idx, _ in param_layout(cfg):
        if path not in out:
            node = tpl
            for key in path:
                node = node[key]
            out[path] = (node.shape, [])
        out[path][1].append((name, idx))
    return {path: out[path] for path in sorted(out)}


def stack_tree(cfg: ArchConfig, flat: dict) -> dict:
    """Tensors keyed by state-dict name (parameters, or an optimizer's
    moments) -> the reference's nested tree, the layers stacked back
    along their scan axes: new CPU tensors, dtypes kept."""
    tree = {}
    for path, (shape, members) in stacked_layout(cfg).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        first = flat[members[0][0]]
        leaf = torch.empty(shape, dtype=first.dtype)
        for name, idx in members:
            leaf[idx] = flat[name].detach()
        node[path[-1]] = leaf
    return tree


def unstack_tree(cfg: ArchConfig, tree: dict) -> dict:
    """The inverse of :func:`stack_tree`: the reference's nested tree ->
    tensors keyed by state-dict name (views of its leaves)."""
    out = {}
    for name, path, idx, _ in param_layout(cfg):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[name] = leaf[idx]
    return out


def params_to_numpy(cfg: ArchConfig, state_dict: dict) -> dict:
    """The inverse of :func:`params_from_numpy`: a state dict -> the
    reference's parameter tree as numpy arrays, bf16 leaves as uint16
    bit views, float32 leaves as float32."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return one(node)
    return walk(stack_tree(cfg, state_dict))


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> dict:
    """The JAX package's parameter tree, as numpy arrays -> a state dict
    of this package's :class:`Model` (``model.load_state_dict(...)``).

    A leaf keeps its template's dtype: float32 leaves come as float32
    and stay so; bf16 leaves come as float32 (a bf16 value round-trips
    through float32 exactly) or as uint16 bit views of bf16.  The scan
    axes are unstacked into the layers in the order the stack runs:
    ``groups/local[g, i]``, ``groups/global[g]`` and ``tail[i]``
    (dense, moe, vlm), ``groups/mamba[g, i]`` and ``tail[i]`` beside the
    one ``shared_attn`` (ssm, hybrid), ``layers[i]`` (encoder).
    """
    device = resolve_device(device)
    out = {}
    for name, path, idx, p in param_layout(cfg):
        arr = tree
        for key in path:
            arr = arr[key]
        out[name] = _leaf(arr[idx] if idx else arr, p.dtype, device)
    return out
