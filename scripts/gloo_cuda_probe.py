#!/usr/bin/env python3
"""Which collectives a gloo world runs on CUDA tensors, one card shared.

    python3 scripts/gloo_cuda_probe.py       # on a machine with a card

Each case runs in a fresh 4-rank world (a rank that crashes takes only
its case down): the functional collectives DTensor issues
(``torch.distributed._functional_collectives``: all-gather, all-reduce,
reduce-scatter, all-to-all) and DTensor redistributions on a (2, 2)
mesh (Shard -> Replicate, Partial -> Replicate, Partial -> Shard,
Shard -> Shard, a sharded matmul's backward), on the card and, for
comparison, Shard -> Replicate on the CPU.  It prints one line a case:
its exit code and the value rank 0 read, or the failure.
"""
import datetime
import os
import subprocess
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = ["fc_all_gather", "fc_all_reduce", "fc_reduce_scatter",
         "fc_all_to_all", "dt_S_to_R", "dt_P_to_R", "dt_P_to_S",
         "dt_S_to_S", "dt_mm_backward", "dt_cpu_S_to_R"]
WORLD = 4


def run_case(case, dev, rank):
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    g = dist.group.WORLD
    if case == "fc_all_gather":
        return (fc.all_gather_tensor(x, 0, g) * 1).sum().item()
    if case == "fc_all_reduce":
        return (fc.all_reduce(x, "sum", g) * 1).sum().item()
    if case == "fc_reduce_scatter":
        return (fc.reduce_scatter_tensor(x, "sum", 0, g) * 1).sum().item()
    if case == "fc_all_to_all":
        return (fc.all_to_all_single(x, None, None, g) * 1).sum().item()
    kind = "cpu" if case == "dt_cpu_S_to_R" else "cuda"
    d = torch.device("cpu") if kind == "cpu" else dev
    mesh = init_device_mesh(kind, (2, 2), mesh_dim_names=("data", "model"))

    def local(shape, pls, leaf=False):
        t = torch.ones(shape, device=d) * (1 if leaf else rank)
        return DTensor.from_local(t.requires_grad_(leaf), mesh, pls,
                                  run_check=False)
    if case in ("dt_S_to_R", "dt_cpu_S_to_R"):
        t, to = local((2, 2), [Shard(0), Shard(1)]), [Replicate()] * 2
    elif case == "dt_P_to_R":
        t, to = local((4, 4), [Partial(), Replicate()]), [Replicate()] * 2
    elif case == "dt_P_to_S":
        t, to = local((4, 4), [Replicate(), Partial()]), [Replicate(),
                                                          Shard(1)]
    elif case == "dt_S_to_S":
        t, to = local((4, 2), [Replicate(), Shard(1)]), [Replicate(),
                                                         Shard(0)]
    else:
        w = local((4, 4), [Shard(0), Shard(1)], leaf=True)
        xx = local((2, 8), [Shard(0), Replicate()])
        y = (xx @ w.redistribute(mesh, [Replicate(), Shard(1)])) \
            .redistribute(mesh, [Shard(0), Replicate()])
        return torch.autograd.grad(y.to_local().sum(), [w])[0] \
            .to_local().sum().item()
    return t.redistribute(mesh, to).to_local().sum().item()


def rank_fn(rank, store, case):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=30))
    value = run_case(case, torch.device("cuda", 0), rank)
    torch.cuda.synchronize()
    if rank == 0:
        print(f"CASE {case}: ok {value}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main():
    if len(sys.argv) > 1:
        case = sys.argv[1]
        store = f"{sys.argv[2]}/probe_{case}_{os.getpid()}"
        mp.spawn(rank_fn, args=(store, case), nprocs=WORLD)
        return
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{WORLD} gloo ranks on card 0", flush=True)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "build", "gloo_probe")
    os.makedirs(work, exist_ok=True)
    for case in CASES:
        try:
            p = subprocess.run([sys.executable, __file__, case, work],
                               capture_output=True, text=True, timeout=60)
        except subprocess.TimeoutExpired:
            print(f"{case}: timed out", flush=True)
            continue
        ok = [l for l in p.stdout.splitlines() if l.startswith("CASE")]
        err = (p.stderr.strip().splitlines() or [""])[-1][:160]
        print(f"{case}: exit {p.returncode} {ok or err}", flush=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])


if __name__ == "__main__":
    main()
