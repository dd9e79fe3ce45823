#!/usr/bin/env python3
"""Time the port's row-tile kernels beside another commit's.

    git archive REV src/repro_torch/csrc | tar -x -C DIR
    python3 scripts/row_tiles_bench.py DIR      # from the repo root, on a card
    python3 scripts/row_tiles_bench.py DIR -k FB   # only the FB shapes

Builds DIR's ``src/repro_torch/csrc/{bank_fold,mcim_fold,karatsuba_ppm}.cu``
and calls their C entry points (``bank_fold_launch``, on a round's rows
in batch order with their owners, or, in commits before that form, on
the same rows as per-instance blocks; FB's and FF's
``mcim_fold_launch``, or ``mcim_fold_{fb,ff}_launch`` in commits before
the two shared one kernel, the folded Karatsuba's
``mcim_fold_karatsuba_launch``, ``karatsuba_ppm_launch``, and their bulk
counterparts ``*_bulk_launch`` where DIR has them, taking a launch a
bulk entry point refuses to the per-thread one) beside this tree's
wrappers, on the main path's shapes and on shapes of the per-thread
path (views 4 bytes off 16, odd row counts, 1-limb, mixed and odd
widths) at 1 to 16 limbs.  For each shape it checks that both give the
same bits, then times them in turns (other, this, this, other), each
warm and cold as ``chip_smoke.py`` phase 2 does (device time, 20 calls
in one CUDA graph; cold: the calls rotate through copies of the
operands larger than twice the L2, each as many bytes off 16 as its
original, so a view keeps its path).
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
SOURCES = ("bank_fold", "mcim_fold", "karatsuba_ppm")
TP3P5_TABLE = [[(0, 2), (0, 0)]] * 3 + [[(0, 1), (1, 2)]]
TP5OVER6_TABLE = [[(0, 4), (4, 8), (0, 0)], [(0, 3), (3, 6), (6, 8)]]


def stream():
    return torch.cuda.current_stream().cuda_stream


def other_kernels(parent):
    """{symbol: ctypes function} of another commit's entry points (a
    bulk entry point it lacks is None), and whether its bank_fold takes
    an owner table."""
    from repro_torch.kernels import _build
    src = pathlib.Path(parent) / "src" / "repro_torch" / "csrc"
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(BUILD / f"other_{n}.so"), str(src / f"{n}.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for n in SOURCES}
    check(all(p.wait() == 0 for p in procs.values()), "other build failed")
    libs = {n: ctypes.CDLL(str(BUILD / f"other_{n}.so")) for n in SOURCES}
    owners = "const void* owner" in (src / "bank_fold.cu").read_text()
    bank_ptrs = 5 if owners else 4
    fns = {}
    for lib, symbol, n_ptrs, n_ints in (
            ("bank_fold", "bank_fold_launch", bank_ptrs, 5),
            ("bank_fold", "bank_fold_bulk_launch", bank_ptrs, 5),
            ("mcim_fold", "mcim_fold_launch", 3, 3),
            ("mcim_fold", "mcim_fold_bulk_launch", 3, 3),
            ("mcim_fold", "mcim_fold_fb_launch", 3, 5),
            ("mcim_fold", "mcim_fold_ff_launch", 3, 5),
            ("mcim_fold", "mcim_fold_ff_bulk_launch", 3, 5),
            ("mcim_fold", "mcim_fold_karatsuba_launch", 3, 3),
            ("karatsuba_ppm", "karatsuba_ppm_launch", 3, 2),
            ("karatsuba_ppm", "karatsuba_ppm_bulk_launch", 3, 2)):
        fn = getattr(libs[lib], symbol, None)
        if fn is not None:
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        fns[symbol] = fn
    return fns, owners


def cases(dev, rng):
    """(label, kind, operands, ct): kind "bank" takes 4 operands (a
    round's rows, instance i's R rows after instance i - 1's, their
    owners and the table), "fb", "ff", "karatsuba" (the folded
    Karatsuba) and "kara" (the spatial one) 2."""
    def view(x, offset=1):   # the same values, `offset` words off 16 bytes
        flat = torch.zeros(x.numel() + offset, dtype=torch.int32,
                           device=dev)
        flat[offset:] = x.reshape(-1)
        return flat[offset:].view(x.shape)

    def table(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    def bank(label, n_inst, rows, bits_a, bits_b, tbl):
        a = operands(rng, (n_inst * rows,), bits_a, dev)[0]
        b = operands(rng, (n_inst * rows,), bits_b, dev)[1]
        owner = torch.arange(n_inst, dtype=torch.int32,
                             device=dev).repeat_interleave(rows)
        yield label, "bank", (a, b, owner, table(tbl)), None
        if bits_a == bits_b and bits_a > 16:
            yield (f"{label}, views 4 B off", "bank",
                   (view(a), view(b), owner, table(tbl)), None)

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
    for label, kind, rows, bits, ct in (
            ("FF tbl8_w32_strict 1048576x2", "ff", 1_048_576, 32, 2),
            ("FF 1048575x2 (odd rows)", "ff", 1_048_575, 32, 2),
            ("FF 524288x4", "ff", 524_288, 64, 2),
            ("FF 262144x16", "ff", 262_144, 256, 2),
            ("FB star of tp3p5_w32 299593x2", "fb", 299_593, 32, 1),
            ("FB fb(ct=2) of tp5over6_w128 629146x8", "fb", 629_146, 128,
             2),
            ("FB 1048576x1 (16-bit)", "fb", 1_048_576, 16, 2),
            ("FB 524288x13 (200-bit)", "fb", 524_288, 200, 3),
            ("karatsuba_ppm 32-bit 1048576x2", "kara", 1_048_576, 32,
             None),
            ("karatsuba_ppm 64-bit 1048576x4", "kara", 1_048_576, 64,
             None),
            ("karatsuba_ppm 128-bit 1048576x8", "kara", 1_048_576, 128,
             None),
            ("karatsuba_ppm 256-bit 1048576x16", "kara", 1_048_576, 256,
             None),
            ("karatsuba_ppm 192-bit 1048576x12", "kara", 1_048_576, 192,
             None)):
        a, b = operands(rng, (rows,), bits, dev)
        yield label, kind, (a, b), ct
        if bits > 32:
            yield f"{label}, views 4 B off", kind, (view(a), view(b)), ct
    # the folded Karatsuba at tp5over6_w128's rows: N = 8, 14 (13 limbs)
    # and 6 (3 x 5 limbs), per-thread path only
    for label, bits_a, bits_b in (
            ("karatsuba fold of tp5over6_w128 419430x8", 128, 128),
            ("karatsuba fold 419430x13 (200-bit)", 200, 200),
            ("karatsuba fold 419430, 3x5 limbs", 48, 80)):
        a = operands(rng, (419_430,), bits_a, dev)[0]
        b = operands(rng, (419_430,), bits_b, dev)[1]
        yield label, "karatsuba", (a, b), 3
        yield f"{label}, views 4 B off", "karatsuba", (view(a), view(b)), 3
    # the same 8-limb rows through both Karatsubas at the other's row
    # count: whether the row count (waves of tiles) or the kernel sets
    # their shares of the byte bound apart
    for label, kind, rows in (
            ("karatsuba fold 1048576x8", "karatsuba", 1_048_576),
            ("karatsuba_ppm 128-bit 419430x8", "kara", 419_430)):
        a, b = operands(rng, (rows,), 128, dev)
        yield label, kind, (a, b), 3 if kind == "karatsuba" else None


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
    from repro_torch.kernels import karatsuba_ppm as KP
    from repro_torch.kernels import mcim_fold as MF
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", torch.cuda.current_device())
    fns, owners = other_kernels(args.other)

    def call(symbol, ptrs, ints):
        """DIR's bulk entry point where it has one and takes the launch,
        else its per-thread one."""
        bulk = fns.get(symbol.replace("_launch", "_bulk_launch"))
        if bulk is not None and bulk(*ptrs, *ints, stream()) == 0:
            return
        check(fns[symbol](*ptrs, *ints, stream()) == 0,
              f"other {symbol} refused")

    def old(kind, ct, *ops):
        if kind == "bank":
            a, b, owner, t = ops
            (batch, la), lb, n = a.shape, b.shape[-1], t.shape[0]
            out = torch.empty((batch, la + lb), dtype=torch.int32,
                              device=dev)
            if owners:
                call("bank_fold_launch", (a.data_ptr(), b.data_ptr(),
                                          owner.data_ptr(), t.data_ptr(),
                                          out.data_ptr()),
                     (n, batch, la, lb, t.shape[1]))
            else:                # the same rows as per-instance blocks
                call("bank_fold_launch", (a.data_ptr(), b.data_ptr(),
                                          t.data_ptr(), out.data_ptr()),
                     (n, batch // n, la, lb, t.shape[1]))
            return out
        a, b = ops
        (bsz, la), lb = a.shape, b.shape[1]
        out = torch.empty((bsz, la + lb), dtype=torch.int32, device=dev)
        ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
        if kind == "kara":
            call("karatsuba_ppm_launch", ptrs, (bsz, la))
        elif kind == "karatsuba":
            call("mcim_fold_karatsuba_launch", ptrs, (bsz, la, lb))
        elif fns["mcim_fold_launch"] is not None:
            call("mcim_fold_launch", ptrs, (bsz, la, lb))
        else:
            geo = MF.fold_geometry(la, lb, ct, kind)
            call(f"mcim_fold_{kind}_launch", ptrs,
                 (bsz, la, lb, geo.ct_run, geo.chunk))
        return out

    def new(kind, ct, *ops):
        if kind == "bank":
            return BF.fused_bank_rows(*ops)
        if kind == "kara":
            return KP.karatsuba_ppm_mul(*ops)
        return MF.mcim_fold_mul(*ops, ct=ct, schedule=kind)

    def path(kind, ops):
        aligned = _row_tiles.is_aligned(*ops[:2])
        if kind == "bank":
            return BF.launch_plan(ops[3].shape[0], *ops[0].shape,
                                  ops[1].shape[-1], aligned)
        if kind == "kara":
            return KP.launch_plan(ops[0].shape[0], ops[0].shape[1], aligned)
        if kind == "karatsuba":
            return "per_thread"
        return _row_tiles.plan(ops[0].shape[0], ops[0].shape[1],
                               ops[1].shape[1], aligned)

    print("other / this tree, ms warm/cold, in turns")
    for label, kind, ops, ct in cases(dev, np.random.default_rng(14)):
        if args.k not in label:
            continue
        o = lambda *x, kind=kind, ct=ct: old(kind, ct, *x)  # noqa: E731
        t = lambda *x, kind=kind, ct=ct: new(kind, ct, *x)  # noqa: E731
        check(torch.equal(t(*ops), o(*ops)), f"{label}: bits differ")
        sets = cold_copies(ops)
        runs = [(name, graph_ms(lambda: f(*ops)), cold_graph_ms(f, sets))
                for name, f in (("other", o), ("this", t), ("this", t),
                                ("other", o))]
        print(f"  {label} [{path(kind, ops)}]: " + "; ".join(
            f"{n} {w:.4f}/{c:.4f}" for n, w, c in runs), flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
