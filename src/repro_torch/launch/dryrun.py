"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step in a
fake world, as the JAX package's ``launch/dryrun.py`` lowers and
compiles it.

Per cell :func:`run_cell`:
  1. sets up a fake world (``torch.distributed``'s ``"fake"`` backend on
     a ``FakeStore``: every collective returns at once) of 256 ranks
     ("pod1", (16, 16) as ("data", "model")) or 512 ("pod2", (2, 16, 16)
     with "pod") and builds ``launch.mesh.make_production_mesh``;
  2. builds the model under ``FakeTensorMode`` (no parameter is
     allocated or initialised) and distributes it by its
     ``param_specs``, with inputs of ``train_input_specs`` /
     ``prefill_input_specs`` (or ``cache_spec`` and one token) placed by
     ``launch.sharding``;
  3. traces one train step (``make_train_step``'s device work, then the
     AdamW update), one prefill or one decode step on rank 0 through
     :mod:`.op_cost`: per-rank flops, bytes, collectives and live bytes;
  4. turns them into :mod:`.roofline` terms and writes the reference's
     result keys, ``trace_s`` standing for its ``lower_s`` and
     ``compile_s``.

The fake world is set up and torn down inside :func:`run_cell`; the
caller must hold no process group (run it in a subprocess otherwise).
Meshes are ``device_type="cuda"`` unless the caller passes ``"cpu"``; a
cuda cell needs a card for the mesh, and its tensors stay fake.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
      --mesh pod1 --out experiments/dryrun_torch [--device-type cpu]
  python -m repro_torch.launch.dryrun --list        # enumerate cells
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import torch
import torch.distributed as dist

from ..configs import ARCH_NAMES, SHAPES, SKIPS, cell_runnable, get_config
from ..models import base
from ..models.api import Model
from ..optim import AdamWConfig, apply_updates, init_state
from ..runtime import make_train_step
from . import op_cost, roofline
from . import sharding as shd
from .mesh import make_production_mesh

#: the card's device memory, for the peak's print
CARD_BYTES = 80 * 2 ** 30
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0),
    destroyed on exit with the groups :func:`base.mesh_group` made."""
    if dist.is_initialized():
        raise RuntimeError("the dry run sets up its own fake world; call "
                           "it where no process group exists (or in a "
                           "subprocess)")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        base._GROUPS.clear()
        dist.destroy_process_group()


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _placed(shape, dtype, mesh, device):
    """An (uninitialised) input of ``shape``: with a ``mesh`` a DTensor
    placed by ``batch_spec`` over dim 0."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if mesh is None:
        return t
    return base.distribute(t, mesh, base.placements(
        shd.batch_spec(mesh, len(shape), shape[0]), mesh))


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               if isinstance(t, base.DTensor) else
               t.numel() * t.element_size()
               for t in _tensors(tree))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _batch(specs: dict, mesh, device) -> dict:
    return {k: _placed(s.shape, s.dtype, mesh, device)
            for k, s in specs.items()}


def build_train(model: Model, shape, mesh, device):
    """(step function, its argument tree, its outputs) of one train
    step (``mesh`` ``None``: the mesh-less step)."""
    opt_cfg = AdamWConfig()
    step = make_train_step(model, opt_cfg, mesh)
    named = dict(model.named_parameters())
    state = init_state(named)
    batch = _batch(model.train_input_specs(shape), mesh, device)

    def fn():
        loss, grads, gsq = step.gradients(batch)
        apply_updates(named, dict(zip(named, grads)), state, opt_cfg)
        return loss, gsq
    return fn, (named, state, batch), (named, state)


def build_prefill(model: Model, shape, mesh, device):
    batch = _batch(model.prefill_input_specs(shape), mesh, device)
    out = {}

    def fn():
        out["caches"], out["logits"] = model.prefill(
            batch, s_cap=shape.seq_len, mesh=mesh)
        return out["logits"]
    return fn, (dict(model.named_parameters()), batch), out


def build_decode(model: Model, shape, mesh, device):
    b, s_cap = shape.global_batch, shape.seq_len
    caches = model.init_cache(b, s_cap, mesh)
    token = _placed((b,), torch.int64, mesh, device)
    pos = _placed((b,), torch.int64, mesh, device)
    out = {}

    def fn():
        out["caches"], out["logits"] = model.decode_step(caches, token, pos,
                                                         mesh=mesh)
        return out["logits"]
    return fn, (dict(model.named_parameters()), caches, token, pos), out


def trace(cfg, shape, mesh, device) -> dict:
    """:mod:`.op_cost`'s counts of one step of ``shape.kind`` for a model
    of ``cfg`` made under ``FakeTensorMode`` on ``device`` (distributed
    on ``mesh`` unless it is ``None``), with ``arg_bytes``,
    ``out_bytes`` (each rank's), ``trace_s`` and the ``model``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        t0 = time.perf_counter()
        model = Model(cfg, device)
        if mesh is not None:
            model.distribute_(mesh)
        build = {"train": build_train, "prefill": build_prefill,
                 "decode": build_decode}[shape.kind]
        fn, args, outs = build(model, shape, mesh, device)
        arg_bytes = _local_bytes(args)
        hc = op_cost.analyze(fn)
        hc.update(trace_s=time.perf_counter() - t0, arg_bytes=arg_bytes,
                  out_bytes=_local_bytes(outs), model=model)
    return hc


def _mesh_of(mesh, mesh_kind, device_type):
    """``mesh`` as given: ``None`` (the production mesh of
    ``mesh_kind``) or a ``(shape, axis names)`` pair -> (the world's
    size, a function making the mesh in it)."""
    from torch.distributed.device_mesh import init_device_mesh
    if mesh is None:
        shape, _ = MESHES[mesh_kind]
        return math.prod(shape), lambda: make_production_mesh(
            multi_pod=(mesh_kind == "pod2"), device_type=device_type)
    shape, names = mesh
    return math.prod(shape), lambda: init_device_mesh(
        device_type, tuple(shape), mesh_dim_names=tuple(names))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: dict | None = None, *, mesh=None, shape_cfg=None,
             smoke: bool = False, device_type: str = "cuda") -> dict:
    """Trace one cell and return the reference's result keys (per-rank
    counts; ``trace_s`` for ``lower_s``/``compile_s``).  ``mesh``:
    ``None`` for ``mesh_kind``'s production mesh, or a ``(shape, axis
    names)`` pair for a fake world of that size."""
    shape = shape_cfg or SHAPES[shape_name]
    cfg = get_config(arch, smoke=smoke, **(overrides or {}))
    n, make = _mesh_of(mesh, mesh_kind, device_type)
    with fake_world(n):
        the_mesh = make()
        hc = trace(cfg, shape, the_mesh, _device(the_mesh))
        n_devices = the_mesh.size()
    model, arg_bytes = hc["model"], hc["arg_bytes"]

    flops, bytes_acc = float(hc["flops"]), float(hc["bytes"])
    link_bytes = hc["link_bytes"]
    terms = roofline.roofline_terms(flops, bytes_acc, link_bytes,
                                    hc["collective_s"])
    n_active = model.active_param_count()
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    mflops = roofline.model_flops(n_active, tokens, shape.kind)
    peak = arg_bytes + hc["peak_bytes"]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind,
        "device_type": device_type,
        "n_devices": n_devices,
        "trace_s": round(hc["trace_s"], 2),
        "params": model.param_count(),
        "active_params": n_active,
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "raw_cost_analysis": {"flops": flops, "bytes": bytes_acc,
                              "bytes_by_op": hc["bytes_by_op"],
                              "loop_scale": 1.0},
        "unknown_trip_whiles": hc["unknown_trip_whiles"],
        "collectives": hc["collectives"],
        "link_bytes_per_device": link_bytes,
        "roofline": terms,
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / n_devices,
        "useful_flops_ratio": (mflops / n_devices) / flops if flops else 0.0,
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            "output_size_in_bytes": hc["out_bytes"],
                            "temp_size_in_bytes": hc["peak_bytes"],
                            "peak_bytes": peak,
                            "card_bytes": CARD_BYTES},
        "n_ops": hc["n_ops"],
        "overrides": overrides or {},
    }


def summary(res: dict) -> str:
    """One line of a cell's result."""
    r = res["roofline"]
    colls = ", ".join(f"{k} {v['count']} ({v['link_bytes'] / 1e9:.3f} GB)"
                      for k, v in res["collectives"].items() if v["count"])
    peak = res["memory_analysis"]["peak_bytes"]
    return (f"{res['arch']} {res['shape']} {res['mesh']} "
            f"({res['n_devices']} ranks, {res['device_type']}): "
            f"{res['flops_per_device']:.4e} flops and "
            f"{res['bytes_per_device']:.4e} bytes a rank; collectives "
            f"{colls or 'none'}; compute {r['compute_s']:.3e} s, memory "
            f"{r['memory_s']:.3e} s, collective {r['collective_s']:.3e} s, "
            f"dominant {r['dominant']}; useful "
            f"{res['useful_flops_ratio']:.3f}; peak {peak / 2 ** 30:.2f} "
            f"GiB a rank of {CARD_BYTES / 2 ** 30:.0f} GiB; trace "
            f"{res['trace_s']} s")


def all_cells():
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            if cell_runnable(arch, shape):
                yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=list(MESHES), default="pod1")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--override", default="",
                    help="comma k=v config overrides (perf experiments)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--device-type", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type (default: cuda)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in all_cells():
            print(f"{arch} {shape}")
        for (arch, shape), why in SKIPS.items():
            print(f"SKIP {arch} {shape}: {why}", file=sys.stderr)
        return None
    if not (args.arch and args.shape):
        ap.error("--arch and --shape name the cell (or --list)")

    overrides = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        overrides[k] = (v if not v.replace("-", "").isdigit() else int(v))
        if v in ("true", "false"):
            overrides[k] = v == "true"

    os.makedirs(args.out, exist_ok=True)
    res = run_cell(args.arch, args.shape, args.mesh, overrides or None,
                   device_type=args.device_type)
    tag = f"_{args.tag}" if args.tag else ""
    path = os.path.join(args.out,
                        f"{args.arch}_{args.shape}_{args.mesh}{tag}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print("OK " + summary(res))
    return res


if __name__ == "__main__":
    main()
