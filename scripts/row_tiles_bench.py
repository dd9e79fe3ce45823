#!/usr/bin/env python3
"""Time the port's bank_fold and FF kernels beside another commit's.

    git archive REV src/repro_torch/csrc | tar -x -C DIR
    python3 scripts/row_tiles_bench.py DIR      # from the repo root, on a card
    python3 scripts/row_tiles_bench.py DIR -k FF   # only the FF shapes

Builds DIR's ``src/repro_torch/csrc/{bank_fold,mcim_fold}.cu`` and calls
their ``bank_fold_launch`` and ``mcim_fold_ff_launch`` (the C interface
both commits share) beside this tree's wrappers, on the main path's
shapes and on shapes of the per-thread path (views 4 bytes off 16, odd
row counts, 1-limb and mixed widths) at 1 to 16 limbs.  For each shape
it checks that both give the same bits, then times them in turns
(other, this, this, other), each warm and cold as ``chip_smoke.py``
phase 2 does (device time, 20 calls in one CUDA graph; cold: the calls
rotate through copies of the operands larger than twice the L2).
"""
import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (check, cold_copies, cold_graph_ms,  # noqa: E402
                        graph_ms, operands)

BUILD = ROOT / "build" / "row_tiles_bench"
TP3P5_TABLE = [[(0, 2), (0, 0)]] * 3 + [[(0, 1), (1, 2)]]
TP5OVER6_TABLE = [[(0, 4), (4, 8), (0, 0)], [(0, 3), (3, 6), (6, 8)]]


def stream():
    return torch.cuda.current_stream().cuda_stream


def other_kernels(parent):
    """ctypes launchers of another commit's bank_fold and FF kernels."""
    from repro_torch.kernels import _build
    src = pathlib.Path(parent) / "src" / "repro_torch" / "csrc"
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(BUILD / f"other_{n}.so"), str(src / f"{n}.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for n in ("bank_fold", "mcim_fold")}
    check(all(p.wait() == 0 for p in procs.values()), "other build failed")
    bank = ctypes.CDLL(str(BUILD / "other_bank_fold.so")).bank_fold_launch
    bank.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    ff = ctypes.CDLL(str(BUILD / "other_mcim_fold.so")).mcim_fold_ff_launch
    ff.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return bank, ff


def cases(dev, rng):
    """(label, operands): 3 operands for bank_fold, 2 for FF."""
    def view(x, offset=1):   # the same values, `offset` words off 16 bytes
        flat = torch.zeros(x.numel() + offset, dtype=torch.int32,
                           device=dev)
        flat[offset:] = x.reshape(-1)
        return flat[offset:].view(x.shape)

    def table(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    def bank(label, n_inst, rows, bits_a, bits_b, tbl):
        a = operands(rng, (n_inst, rows), bits_a, dev)[0]
        b = operands(rng, (n_inst, rows), bits_b, dev)[1]
        yield label, (a, b, table(tbl))
        if bits_a == bits_b and bits_a > 16:
            yield f"{label}, views 4 B off", (view(a), view(b), table(tbl))

    yield from bank("bank_fold tp3p5_w32 4x300032x2", 4, 300_032, 32, 32,
                    TP3P5_TABLE)
    yield from bank("bank_fold tp5over6_w128 2x629248x8", 2, 629_248, 128,
                    128, TP5OVER6_TABLE)
    yield from bank("bank_fold 2x629248x4", 2, 629_248, 64, 64,
                    [[(0, 2), (2, 4)], [(0, 4), (0, 0)]])
    yield from bank("bank_fold 2x300032x16", 2, 300_032, 256, 256,
                    [[(0, 8), (8, 16)], [(0, 16), (0, 0)]])
    yield from bank("bank_fold 1x1048576x1 (16-bit)", 1, 1_048_576, 16, 16,
                    [[(0, 1)]])
    yield from bank("bank_fold 2x300032, 3x5 limbs", 2, 300_032, 48, 80,
                    [[(0, 5), (0, 0)], [(0, 3), (3, 5)]])
    for label, rows, bits in (("FF tbl8_w32_strict 1048576x2", 1_048_576, 32),
                              ("FF 1048575x2 (odd rows)", 1_048_575, 32),
                              ("FF 524288x4", 524_288, 64),
                              ("FF 262144x16", 262_144, 256)):
        a, b = operands(rng, (rows,), bits, dev)
        yield label, (a, b)
        if bits > 32:
            yield f"{label}, views 4 B off", (view(a), view(b))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="a directory holding another "
                        "commit's src/repro_torch/csrc")
    parser.add_argument("-k", default="", help="time only the shapes "
                        "whose label holds this text")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("row_tiles_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _row_tiles
    from repro_torch.kernels import bank_fold as BF
    from repro_torch.kernels import mcim_fold as MF
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", torch.cuda.current_device())
    old_bank_fn, old_ff_fn = other_kernels(args.other)

    def old_bank(a, b, t):
        n, rows, la = a.shape
        lb = b.shape[-1]
        out = torch.empty((n, rows, la + lb), dtype=torch.int32, device=dev)
        check(old_bank_fn(a.data_ptr(), b.data_ptr(), t.data_ptr(),
                          out.data_ptr(), n, rows, la, lb, t.shape[1],
                          stream()) == 0, "other bank_fold refused")
        return out

    def old_ff(a, b):
        (bsz, la), lb = a.shape, b.shape[1]
        geo = MF.fold_geometry(la, lb, 2, "ff")
        out = torch.empty((bsz, la + lb), dtype=torch.int32, device=dev)
        check(old_ff_fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, la,
                        lb, geo.ct_run, geo.chunk, stream()) == 0,
              "other FF refused")
        return out

    def new_ff(a, b):
        return MF.mcim_fold_mul(a, b, ct=2, schedule="ff")

    print("other / this tree, ms warm/cold, in turns")
    for label, ops in cases(dev, np.random.default_rng(14)):
        if args.k not in label:
            continue
        bank = len(ops) == 3
        new, old = (BF.fused_bank_mul, old_bank) if bank else (new_ff, old_ff)
        aligned = _row_tiles.is_aligned(*ops[:2])
        path = (BF.launch_plan(*ops[0].shape, ops[1].shape[-1], aligned)
                if bank else
                MF.ff_launch_plan(*ops[0].shape, ops[1].shape[1], aligned))
        check(torch.equal(new(*ops), old(*ops)), f"{label}: bits differ")
        sets = cold_copies(ops)
        runs = [(name, graph_ms(lambda: f(*ops)), cold_graph_ms(f, sets))
                for name, f in (("other", old), ("this", new),
                                ("this", new), ("other", old))]
        print(f"  {label} [{path}]: " + "; ".join(
            f"{n} {w:.4f}/{c:.4f}" for n, w, c in runs), flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
