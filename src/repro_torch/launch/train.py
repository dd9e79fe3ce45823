"""Training launcher, as the JAX package's ``launch/train.py``.

Runs on the CUDA card unless ``--device cpu``; the data comes from the
ported sources (``--source pattern|synthetic|binfile``), nothing is
downloaded.  Examples:

  # tiny end-to-end on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --smoke --steps 20 --source pattern --device cpu

  # ~100M-parameter run on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --preset 100m --steps 200 --seq-len 256 --global-batch 8

  # four ranks, a (2, 2) ("data", "model") mesh (one card a rank)
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch gemma3-1b --model-parallel 2 --global-batch 8

A world of several ranks (torch's launcher variables, or a process
group the caller made) trains on ``launch.mesh.make_host_mesh`` with
``--model-parallel`` ranks on the model axis; each data shard draws its
own rows.  Under the launcher's variables each rank takes the card
``LOCAL_RANK`` and NCCL (``--device cpu``: gloo on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch.distributed as dist

from ..configs import ARCH_NAMES, get_config
from ..data import DataConfig, make_source
from ..device import resolve_device
from ..models import build_model
from ..optim import AdamWConfig
from ..runtime import TrainerConfig, train
from ..runtime.trainer import maybe_init_distributed
from .mesh import make_host_mesh

# ~100M-parameter preset wiring (applied on top of any arch's family)
PRESET_100M = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                   head_dim=64, d_ff=3072, vocab_size=32000,
                   q_chunk=256, k_chunk=256, ce_chunk=256)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="qwen3-32b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--preset", choices=["", "100m"], default="")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--exact-accum", action="store_true",
                    help="MCIM 128-bit fixed-point grad accumulation")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--source", default="pattern",
                    choices=["pattern", "synthetic", "binfile"])
    ap.add_argument("--data-path", default="")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    maybe_init_distributed(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.model_parallel > 1 and world == 1:
        raise ValueError(f"--model-parallel {args.model_parallel} needs a "
                         f"world of several ranks (torchrun)")

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.preset == "100m":
        cfg = dataclasses.replace(get_config(args.arch), **PRESET_100M)
    device = resolve_device(args.device)
    model = build_model(cfg, device)
    mesh, shard, shards = None, 0, 1
    if world > 1:
        mesh = make_host_mesh(args.model_parallel, device.type)
        shard, shards = mesh.get_coordinate()[0], mesh.size(0)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[train] arch={cfg.name} "
              f"params={model.param_count()/1e6:.1f}M family={cfg.family} "
              f"device={device}"
              + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else ""))

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch, source=args.source,
                      path=args.data_path)
    src = make_source(data, host_index=shard, host_count=shards,
                      device=device)

    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps,
                         microbatches=args.microbatches,
                         exact_accum=args.exact_accum,
                         checkpoint_every=args.checkpoint_every,
                         checkpoint_dir=args.checkpoint_dir)
    res = train(model, src, opt, tcfg, resume=not args.no_resume,
                mesh=mesh)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[train] done: step={res.final_step} "
              f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
              f"skipped={res.skipped_steps} "
              f"stragglers={len(res.straggler_steps)}")
    return res


if __name__ == "__main__":
    main()
