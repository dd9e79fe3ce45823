"""Parameter templates and the common NN primitives of the model stack.

A model is described by a *template*: a nested dict whose leaves are
:class:`Param` descriptors carrying shape, dtype, logical sharding axes
and an initializer, as in the JAX package's ``models/base.py``.  The
port derives from one template the parameter count and the initial
values (:func:`initialize_`); :class:`repro_torch.models.Model` holds
the values as ``nn.Parameter``s under the template's leaf names.

The primitives compute in float32 and cast back to the input's dtype at
the reference's points (``rms_norm``, ``softcap``, ``rope``), and
``swiglu`` rounds ``silu(g)`` to the working dtype before the product,
so bf16 results round where the reference's do.  Matmuls stay
``torch.matmul`` in the working dtype, through :func:`matmul`: one call
shape for every row count, so a row's bits do not depend on its batch
(serving), or one call over all rows (training).
:func:`cross_entropy_chunked` is the training loss's streamed
cross-entropy.

Sharding, as the reference's: ``resolve_logical`` maps a leaf's logical
axes to a :class:`P` over a mesh's axis names ("batch" -> the data axes,
"fsdp" -> "data", "model" -> "model"), dropping an axis whose size does
not divide the dim.  On a ``torch.distributed`` ``DeviceMesh`` a spec
becomes DTensor placements (:func:`placements`), :func:`constrain`
becomes ``redistribute``, and the mesh path runs on DTensors:

  * a parameter is gathered over the data axes where it is used
    (:func:`gathered`, FSDP) and keeps its model-axis shard; a matmul
    whose output comes back ``Partial`` over the model axis is reduced
    at once (:func:`matmul`; serving runs its fixed-shape calls on each
    rank's shards);
  * a computation DTensor has no rule for (a lookup, the attention, the
    expert dispatch, the SSD scan, the loss) runs on each rank's shards
    through :func:`local_map`, which declares the gradient of an input
    replicated over a mesh axis the computation splits ``Partial``;
  * a scalar summed over the data axes goes through :func:`psum`, one
    all-reduce over the flattened axes (:func:`mesh_group`), so every
    rank holds the same bits.

The helpers read only a mesh's axis names and sizes (a ``DeviceMesh``,
or any object with ``axis_names`` and a ``shape`` dict, as the
reference's meshes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class Param:
    shape: tuple
    logical: tuple               # logical axis name (or None) per dim
    dtype: Any = torch.bfloat16
    init: str = "normal"         # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_param(x) -> bool:
    return isinstance(x, Param)


def leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict (a template's leaves are
    ``Param``s), in key order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key, sub in tree.items():
        yield from leaves(sub, prefix + (key,))


def _tree_map(f, template):
    if is_param(template):
        return f(template)
    return {k: _tree_map(f, v) for k, v in template.items()}


def initialize_(t: torch.Tensor, p: Param, generator: torch.Generator):
    """Fill ``t`` in place with ``p``'s initializer (the reference's:
    normal x scale, "scaled" = normal / sqrt(fan_in), zeros, ones), drawn
    in float32 from ``generator`` and cast to ``t``'s dtype."""
    if p.init == "zeros":
        return t.zero_()
    if p.init == "ones":
        return t.fill_(1)
    if p.init == "scaled":        # variance-scaled for output projections
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        std = p.scale
    draw = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                       device=t.device)
    return t.copy_(draw.mul_(std))


def stack(template, n: int, axis_name: str | None = None):
    """Prepend a stacking (layer) axis to every Param in the template."""
    return _tree_map(
        lambda p: Param((n,) + p.shape, (axis_name,) + p.logical,
                        p.dtype, p.init, p.scale),
        template)


def abstract_params(template):
    """The template's tree with a meta tensor of each leaf's shape and
    dtype (the reference's ``ShapeDtypeStruct`` tree)."""
    return _tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                           device="meta"), template)


def param_count(template) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(template))


# ------------------------------------------------------------------ sharding

class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry a
    dim, ``None``, a mesh axis name or a tuple of names.  A tuple, so
    ``tuple(spec)`` compares with the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def mesh_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a reference mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def mesh_axes(mesh) -> dict:
    """Map logical axis names -> physical mesh axes for this mesh."""
    names = mesh_names(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    return {
        "batch": data_axes if len(data_axes) != 1 else data_axes[0],
        "fsdp": "data" if "data" in names else None,
        "model": "model" if "model" in names else None,
        "seq": None,            # overridden to "data" for long-ctx caches
        "seq_data": data_axes if len(data_axes) != 1 else data_axes[0],
        None: None,
    }


def axis_size(mesh, axes) -> int:
    """The ranks over ``axes`` (a name, a tuple of names, or ``None``) of
    ``mesh``: 1 off-mesh and for an axis the mesh lacks."""
    if mesh is None or axes is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape.get(a, 1) for a in
                     (axes if isinstance(axes, tuple) else (axes,)))


def resolve_logical(logical: tuple, shape: tuple, mesh) -> P:
    """Logical axes -> PartitionSpec with divisibility fallback."""
    table = mesh_axes(mesh)
    out = []
    for dim, name in zip(shape, logical):
        phys = table.get(name)
        if phys is None or dim % axis_size(mesh, phys) != 0:
            out.append(None)
        else:
            out.append(phys)
    return P(*out)


def spec_tree(template, mesh):
    return _tree_map(lambda p: resolve_logical(p.logical, p.shape, mesh),
                     template)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that entry ``i`` names (a tuple entry shards on each of its
    axes, in order: the reference's device order), ``Replicate()`` on
    every other."""
    names = mesh_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for name in entry if isinstance(entry, tuple) else (entry,):
            if name is not None:
                out[names.index(name)] = Shard(dim)
    return tuple(out)


def local_chunk(t: torch.Tensor, mesh, pls) -> torch.Tensor:
    """This rank's chunk of the full tensor ``t`` at placements ``pls``
    (shards split in mesh-dim order, as DTensor lays them out): a
    view."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return t


def shard_slice(t: DTensor, dim: int) -> slice:
    """The stretch of ``t``'s dim ``dim`` this rank's shard holds (mesh
    dims that split it, in order, each splitting the one before's chunk;
    the whole dim if none does)."""
    mesh = t.device_mesh
    lo, n = 0, t.shape[dim]
    for i, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            n //= mesh.size(i)
            lo += mesh.get_local_rank(mesh.mesh_dim_names[i]) * n
    return slice(lo, lo + n)


def distribute(t: torch.Tensor, mesh, pls) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor at
    ``pls``: each rank keeps a copy of its own chunk, no collective."""
    return DTensor.from_local(local_chunk(t, mesh, pls).clone(), mesh, pls,
                              run_check=False)


def shard_tree(tree, specs, mesh):
    """A nest of dicts of full tensors -> DTensors at ``specs``."""
    if not isinstance(tree, dict):
        return distribute(tree, mesh, placements(specs, mesh))
    return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}


def constrain(x, mesh, *logical):
    """``redistribute`` to the logical axes' placements (no-op off-mesh)."""
    if mesh is None:
        return x
    spec = resolve_logical(tuple(logical), x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def gathered(w):
    """A parameter as a computation takes it: gathered over the data axes
    (FSDP), its model-axis shard kept."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    pls = tuple(Replicate() if names[i] in ("pod", "data") else pl
                for i, pl in enumerate(w.placements))
    return w.redistribute(mesh, pls) if pls != tuple(w.placements) else w


def reduced(x):
    """``x`` with every ``Partial`` placement all-reduced."""
    if not isinstance(x, DTensor) or \
            not any(pl.is_partial() for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if pl.is_partial() else pl for pl in x.placements))


def on_model(pls, mesh, pl) -> tuple:
    """Placements ``pls`` with ``pl`` on the model axis (if the mesh has
    one)."""
    pls = list(pls)
    if "model" in mesh_names(mesh):
        pls[mesh_names(mesh).index("model")] = pl
    return tuple(pls)


def model_sharded(t: DTensor, mesh) -> bool:
    """``t`` is split over a model axis of more than one rank."""
    names = mesh_names(mesh)
    return "model" in names and mesh.size(names.index("model")) > 1 \
        and t.placements[names.index("model")].is_shard()


def batch_placed(x, mesh, model_pl):
    """``x`` batch-sharded over the data axes (dim 0, where it divides)
    with ``model_pl`` on the model axis."""
    spec = resolve_logical(("batch",) + (None,) * (x.ndim - 1), x.shape,
                           mesh)
    return x.redistribute(mesh, on_model(placements(spec, mesh), mesh,
                                         model_pl))


def local_map(fn, mesh, args, out_placements=None):
    """``fn`` on each rank's shards of ``args`` (DTensors at the
    placements the computation needs; other values pass through) ->
    DTensors at ``out_placements`` (one tuple of placements, or a list
    of them for several outputs), or ``fn``'s plain result if ``None``.

    The gradient of an input replicated over a mesh dim that the
    computation splits (some input or output is sharded there, or an
    output partial) comes back ``Partial`` there: each rank computed
    only its share of it."""
    outs = [] if out_placements is None else out_placements \
        if isinstance(out_placements, list) else [out_placements]
    split = {i for pls in [a.placements for a in args
                           if isinstance(a, DTensor)] + outs
             for i, pl in enumerate(pls) if not pl.is_replicate()}
    local = []
    for a in args:
        if isinstance(a, DTensor):
            grad = tuple(Partial() if pl.is_replicate() and i in split
                         else pl for i, pl in enumerate(a.placements))
            a = a.to_local(grad_placements=grad)
        local.append(a)
    out = fn(*local)
    if out_placements is None:
        return out
    if isinstance(out_placements, list):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o, pl in zip(out, out_placements))
    return DTensor.from_local(out, mesh, out_placements, run_check=False)


_GROUPS = {}


def mesh_group(mesh, axes: tuple):
    """The process group over ``axes`` of ``mesh`` flattened (this
    rank's), made once a mesh; every rank must ask at the same point."""
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (mesh, axes)
    if key not in _GROUPS:
        names = mesh.mesh_dim_names
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        # the mesh's rank table is real, also under the dry run's
        # FakeTensorMode and op counter: read it with no mode active
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            table = mesh.mesh.numpy()
        ranks = table.transpose(*rest, *keep).reshape(
            -1, math.prod(mesh.size(i) for i in keep))
        mine, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        _GROUPS[key] = mine
    return _GROUPS[key]


class _SumOver(torch.autograd.Function):
    """All-reduce sum over ``group``; the backward passes the gradient
    through (every rank holds the same sum and takes the same loss)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """``t`` summed over ``axes`` of ``mesh`` (one all-reduce over the
    flattened axes); ``t`` itself where they hold one rank."""
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if axis_size(mesh, axes) == 1:
        return t
    return _SumOver.apply(t, mesh_group(mesh, axes))


# ------------------------------------------------------------------ primitives

#: rows of every matmul call :func:`matmul` makes
MATMUL_ROWS = 64


def matmul(x, w, train: bool = False):
    """``x @ w``, as fixed-shape ``(MATMUL_ROWS, K) @ (K, N)`` calls over
    the rows of ``x`` (the last call's rows padded with zeros); with
    ``train``, as one call over all rows.

    cuBLAS picks its kernel, and with it the order a row's products are
    summed in, by the row count: a decode step's row (M = slots) and the
    same row inside a prefill (M = batch x sequence) then round to bf16
    apart now and then, and over gemma2-9b's 42 layers those flips grow
    to 0.15 of the logits' std.  One call shape gives a row the same
    bits in any batch.

    Training has no decode step to match, and there the fixed calls
    would cost precision: autograd would sum a bf16 weight's gradient
    from one bf16 piece a call, where one product over all rows (the
    reference's einsum) rounds it once.

    A DTensor ``w`` (the mesh path) is :func:`gathered`.  In training it
    is multiplied as one DTensor product; serving runs the fixed-shape
    calls on each rank's rows and its shard of ``w`` (:func:`local_map`),
    so a row keeps its bits in any batch there too.  A ``Partial`` result
    (a row-parallel weight) is all-reduced at once.
    """
    if isinstance(w, DTensor):         # the mesh path
        if train:
            return reduced(x @ gathered(w))
        return _matmul_local(x, gathered(w))
    if x.dtype != w.dtype:             # jnp's promotion (bf16 @ f32 -> f32)
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if train:
        return x @ w
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, k)
    n = rows.shape[0]
    if n % MATMUL_ROWS:
        rows = F.pad(rows, (0, 0, 0, MATMUL_ROWS - n % MATMUL_ROWS))
    if rows.shape[0] == MATMUL_ROWS:
        out = rows @ w
    else:
        out = torch.cat([t @ w for t in rows.split(MATMUL_ROWS)])
    return out[:n].reshape(*lead, w.shape[-1])


def _matmul_f32(x, w):
    """:func:`matmul` of ``x`` and ``w`` taken to float32 (products of
    bf16 values are exact there): a float32 result, unrounded."""
    return matmul(x.to(torch.float32), w.to(torch.float32))


def _matmul_local(x: DTensor, w: DTensor) -> DTensor:
    """:func:`matmul`'s fixed-shape calls on each rank's rows of ``x``
    against its model-axis shard of a 2-D ``w`` (replicated over the
    data axes): a column shard gives the output's column shard; a row
    shard takes ``x``'s last dim split alike (a local slice) and gives
    float32 partial sums, reduced in float32 and rounded once, as one
    product over the whole contraction rounds (bf16 partials summed in
    bf16 would round each row-parallel output three times)."""
    mesh = w.device_mesh
    model = w.placements[mesh_names(mesh).index("model")] \
        if "model" in mesh_names(mesh) else Replicate()
    x_pl, out_pl, fn = Replicate(), model, matmul
    if model.is_shard(0):                        # row-parallel
        x_pl, out_pl = Shard(x.ndim - 1), Partial()
        if model_sharded(w, mesh):
            fn = _matmul_f32
    elif model.is_shard():                       # column-parallel
        out_pl = Shard(x.ndim - 1)
    pls = tuple(Replicate() if pl.is_partial() else pl
                for pl in x.placements)
    if "model" in mesh_names(mesh):
        pls = on_model(pls, mesh, x_pl)
    if pls != tuple(x.placements):
        x = x.redistribute(mesh, pls)
    out = local_map(fn, mesh, (x, w), on_model(pls, mesh, out_pl))
    return reduced(out).to(torch.promote_types(x.dtype, w.dtype))


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    xf = x.to(torch.float32)
    return (torch.tanh(xf / cap) * cap).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, H, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), exponent)
    ang = positions[..., :, None, None].to(torch.float32) * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, train: bool = False):
    g = matmul(x, w_gate, train)
    u = matmul(x, w_up, train)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return matmul(h, w_down, train)


def gelu_mlp(x, w_in, w_out):
    h = matmul(x, w_in)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return matmul(h, w_out)


def cross_entropy_chunked(logits_fn, x, labels, mask, chunk: int = 512,
                          final_cap: float | None = None, mesh=None):
    """Streamed mean cross-entropy over the positions ``mask`` weights.

    logits_fn: (B, c, D) -> (B, c, V).  The sequence runs in chunks of
    ``chunk`` (one chunk when ``chunk`` does not divide it), each
    recomputed in the backward pass (``checkpoint``), so only one
    chunk's (B, c, V) float32 logits is alive at a time.  Logits are
    softcapped, then taken to float32 for the ``logsumexp``; the gold
    logit is a gather, the same float32 value as the reference's one-hot
    sum (every other term is zero).  Sums run in float32, chunk by
    chunk, as the reference's scan.

    On a ``mesh`` (``x``, ``labels``, ``mask`` DTensors sharded over the
    batch) the logits are constrained to ("batch", None, "model"); with
    the vocabulary split over the model axis each rank takes its shard's
    max and sum of exponents and the gold logit where the label lies in
    its shard, each all-reduced over the model axis (one non-zero term:
    the gold logit keeps its bits), and the loss and count are summed
    over the data axes.
    """
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # fallback: single chunk
    if mesh is not None:
        return _cross_entropy_mesh(logits_fn, x, labels, mask, chunk,
                                   final_cap, mesh)

    def body(xs, ls, ms):
        logits = softcap(logits_fn(xs), final_cap).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, ls[..., None].long())[..., 0]
        return ((lse - gold) * ms).sum()

    mask = mask.to(torch.float32)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        ms = mask[:, i:i + chunk]
        loss_sum = loss_sum + checkpoint(body, x[:, i:i + chunk],
                                         labels[:, i:i + chunk], ms,
                                         use_reentrant=False)
        cnt = cnt + ms.sum()
    return loss_sum / torch.clamp(cnt, min=1.0)


class _VocabLSE(torch.autograd.Function):
    """``logsumexp`` over the last dim of logits whose vocabulary is
    split over ``group`` (``None``: not split): torch's own formula and
    gradient, ``log(sum(exp(l - max))) + max`` and ``g * exp(l - lse)``,
    so an unsplit vocabulary gives ``torch.logsumexp``'s bits."""

    @staticmethod
    def forward(ctx, logits, group):
        m = torch.amax(logits, dim=-1, keepdim=True)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        total = torch.exp(logits - m).sum(-1)
        if group is not None:
            dist.all_reduce(total, group=group)
        out = torch.log(total) + m[..., 0]
        ctx.save_for_backward(logits, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        logits, out = ctx.saved_tensors
        return grad[..., None] * torch.exp(logits - out[..., None]), None


def _cross_entropy_mesh(logits_fn, x, labels, mask, chunk, final_cap,
                        mesh):
    model_n = axis_size(mesh, mesh_axes(mesh)["model"])

    def body(xs, ls, ms):
        logits = constrain(logits_fn(xs), mesh, "batch", None, "model")
        logits = softcap(logits, final_cap).to(torch.float32)
        split = model_n > 1 and logits.shape[-1] % model_n == 0
        group = mesh_group(mesh, ("model",)) if split else None
        v0 = mesh.get_local_rank("model") * (logits.shape[-1] // model_n) \
            if split else 0

        def nll(lg, lb, mk):
            lse = _VocabLSE.apply(lg, group)
            if group is None:
                gold = lg.gather(-1, lb[..., None].long())[..., 0]
            else:
                idx = lb.long() - v0
                mine = (idx >= 0) & (idx < lg.shape[-1])
                gold = torch.where(mine, lg.gather(
                    -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0],
                    0.0)
                gold = _SumOver.apply(gold, group)
            return ((lse - gold) * mk).sum()
        return local_map(nll, mesh, (logits, ls, ms))

    mask = mask.to(torch.float32)
    dev = mask.to_local().device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(0, x.shape[1], chunk):
        ms = mask[:, i:i + chunk]
        loss_sum = loss_sum + checkpoint(body, x[:, i:i + chunk],
                                         labels[:, i:i + chunk], ms,
                                         use_reentrant=False)
        cnt = cnt + ms.to_local().sum()
    # the sum runs over the axes the batch is split over (a batch that
    # does not divide is whole on every rank of the data axes)
    data = tuple(mesh.mesh_dim_names[i]
                 for i, pl in enumerate(labels.placements) if pl.is_shard())
    both = psum(torch.stack([loss_sum, cnt]), mesh, data)
    return both[0] / torch.clamp(both[1], min=1.0)
