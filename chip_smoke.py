#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (any failure ends the run with a non-zero exit; none is caught):

1. Print the card (``nvidia-smi`` name and power limit), build the
   hand-written CUDA kernels from ``src/repro_torch/csrc`` and print
   each kernel's registers, spills and ptxas warnings (``-Xptxas -v``),
   the int8 wgmma kernels' dynamic shared memory, and the bulk kernels of
   ``bank_fold`` and of FB and FF (one kernel) at each width and of the
   spatial Karatsuba (2 limbs): threads, tile rows, stages, dynamic
   shared memory and the persistent grid's blocks an SM, as the CUDA
   source fixes them.
2. Hold each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes (per-instance row counts of a
   B = 1,048,576 round), and time kernel, plain version and, where one
   exists, a single PyTorch call computing the same function.  Kernel
   and library times are device times: 20 calls captured in one CUDA
   graph and replayed, so no host work sits between launches; the older
   figure (20 calls launched from Python) is printed beside them.
   The row-tile kernels (``bank_fold`` on both designs, FB at star's and
   the 8-limb FB's rows, FF, the folded Karatsuba at its 8-limb rows, the
   spatial Karatsuba at 128 and 256 bits) also get a cold figure, for
   the kernel and the library call: the
   graph's calls rotate through copies of the operands whose bytes
   exceed twice the L2, each call writing an output of its own (only the
   cold figure is held to the HBM bound: warm operands stay in the L2);
   their other path (bulk or per-thread) is held against the plain
   version and timed on the same inputs, where it takes them (the bulk
   path does not take star's odd row count, nor the spatial
   Karatsuba's rows above 2 limbs; the folded Karatsuba has no bulk
   path); both Karatsubas' cold times are also given as a share of the
   reference's operation count (5 operations a limb product); and FF and
   the int64 ``*`` are timed warm over 0.5-2 million 2-limb rows, where
   each falls out of the L2.
3. The main path: for each of the 13 registry designs,
   ``repro_torch.designs.generate(name)`` (auto: the fused capability)
   multiplies B = 65,536 operand pairs at the design's full width,
   checked against the plain (core) bank on the card and the Python
   bigint oracle on 1,024 rows; each round must add exactly
   ``bank.launch_count(B) == 1`` to the bank kernel's counter.  A signed
   design and ``mul(0xDEADBEEF, 0xCAFEBABE)`` run too.  Then every
   unsigned design runs again on the per-instance ``kernel`` capability,
   one launch per busy instance.
   Phase 2 also holds the slice-2 kernels at their paths' full shapes:
   the prefix adder on the PPM columns of B = 1,048,576 128- and
   256-bit products, the spatial Karatsuba on B = 1,048,576 128- and
   256-bit pairs, and the int8 matmul at gemma2-9b's MLP up-projection
   (K = 3584, N = 14336) for a prefill chunk (M = 2048) and a decode
   batch (M = 64), where the wgmma kernel that ``int8_matmul`` picks is
   also timed against the mma.sync kernel on the same inputs; then both
   wgmma tile shapes over M = 1 to 512, where ``kernel_path`` switches.
4. Time whole fused rounds of tp3p5_w32 and tp5over6_w128 at
   B = 1,048,576 with CUDA events.
5. The slice-2 entry points: ``fast_final_adder(L.ppm(a, b))`` and
   ``kara_mul(a, b)`` on B = 65,536 128- and 256-bit pairs (equal to
   each other and to the bigint oracle on 1,024 rows),
   ``repro_torch.quant.quantized_matmul`` at both gemma2-9b shapes (bit
   for bit its plain version, within 2% relative error of ``x @ w``),
   and one ``optim.compress`` round trip of a 3584 x 14336 gradient;
   each kernel call must add exactly one launch to its counter.
6. Serving: ``CompiledDesign.serve`` (``repro_torch.serving.Worker``:
   admit, steal, one bank round a replica and window) on the card, with
   ``check=True`` (every product against the bigint oracle).  2,048
   Poisson requests at 0.7x the plan's throughput over 2 replicas on
   tp3p5_w32, tp5over6_w128 and signed tp3p5_w32 (fused: one
   ``bank_fold`` launch a round) and on tbl8_w128_strict with
   ``backend="kernel"`` (one launch a busy instance a round); 512
   requests at 2.5x on tp3p5_w32, where some must be refused; and a
   diurnal trace on tp3p5_w32 with an ``Autoscaler`` whose
   ``recommend`` reads ``autotune.search("tp3p5_w32")``.  Each run must
   be bit-exact, admit no request past its deadline, and equal the same
   run on ``device="cpu"`` in every response and every report field but
   ``wall_s``; it prints requests, rounds, launches a round, latency p50
   and p99 in bank cycles, goodput, and wall ms a round with the share
   of it spent in ``Bank.report``.
7. Replication and the determinism path.  (a) ``tp3p5_w32`` and
   ``tp5over6_w128`` with ``replicas=2`` through ``generate(spec,
   devices=...)``.mul at B = 1,048,576, fused and ``kernel``, over
   ``[cuda:0, cuda:0]`` (and two cards when there are two): bit-exact
   against phase 4's single bank and the bigint oracle on 65,536 sampled
   rows, launches = 2 x one replica's, ``report``/``throughput``/
   ``area``/``peak_power_mw`` equal to the CPU's, and ``replicas`` one
   past the card count refused; the sharded round is timed beside the
   single one.  (b) A world of 2 processes (``gloo`` on one card, whose
   ranks share it; ``nccl`` with a card a rank) runs ``exact_psum`` and
   ``compressed_psum`` on (3584, 14336) float32 gradients on the card:
   the exact sum the same bits with the ranks' inputs swapped and equal
   to ``exact_sum`` over the stacked inputs (on the card, and on the
   CPU for sampled rows), the compressed mean and error equal bit for
   bit to the same world's run on CPU copies, within 5% of the float64
   mean.  (c) ``SyntheticLM`` at gemma2-9b's ``train_4k`` batch (256 x
   4,097 Philox offsets, vocab 256,000), ``PatternLM`` and
   ``BinTokenFile`` (a corpus written under ``build/``) on the card,
   each equal to the same call with ``device="cpu"``; the Random123
   known vector on the card; the Philox draw timed.
8. Model serving: ``repro_torch.launch.serve.main`` with its defaults
   serves gemma2-9b at full width and depth (42 layers, d_model 3584,
   vocab 256,000, 9,241,404,928 parameters from a seeded init on the
   card): 8 requests, 4 slots, prompt 32, 16 new tokens, the admission
   trace replayed through tp3p5_w32.  It prints the init time, the
   batched prefill and the engine's decode step (CUDA events, and one
   step in a CUDA graph for its device time), the step's aten calls,
   tokens/s, peak memory and the step's byte bound (weights and KV cache
   over 3.35 TB/s).  Gates: decode steps against fresh prefills (2 x 64
   tokens, 3 teacher-forced steps) within 0.1 of the logits' std; the
   int8 KV cache on the same weights serves 4 requests and its argmax
   agrees with the bf16 cache's on at least half of 4 x 16
   teacher-forced rows, and ``int_einsum``'s integer dots equal the
   CPU's at S = 56 and 4096; a 2-layer gemma2-9b at full width (vocab
   512) gives the CPU's logits within 0.1 through prefill and 3 decode
   steps; gemma3-1b at full width serves 4 prompts of 1,024 tokens,
   past its 512-token window (ring caches), and its decode matches
   prefill at a 1,024-token prefix within 0.05.  Phase 5 also holds
   ``quantize_rows`` of the gemma2-9b weight to the CPU's bits.  No
   kernel of phases 2-7 lies on this path.
9. The other model families, each at full width from a seeded init on
   the card and freed before the next: (a) llama4-scout-17b-a16e at 12
   of its 48 layers (28,496,163,840 parameters, 57.0 GB) through
   ``ServeEngine`` at the serve CLI's defaults (8 requests, 4 slots,
   prompt 32, 16 new): the batched prefill (expert choice, C = 8), the
   decode step (dense token choice over all 16 experts) eager and as a
   CUDA graph against its byte bound, decode = a token-choice prefill
   (1 x 33-35 tokens) within 0.1, and the token-choice decode against
   expert-choice prefills printed (routing differs by design); (b, c)
   mamba2-370m and zamba2-1.2b at full depth through ``ServeEngine`` with
   4 prompts of 1,000 tokens (8 SSD chunks, the last padded): prefill,
   step eager and graph, byte bound (zamba2's shared block once per
   application), decode against a fresh prefill (gate 0.5; by depth
   where it passes the reference's smoke tolerance); (d) hubert-xlarge's
   ``encoder_forward`` of 4 x 1,000 frames against its byte and
   operation bound; (e) paligemma-3b's ``vlm_prefill`` of 4 x (256 image
   + 32 text) tokens and 16 decode steps, timed, decode = prefill within
   0.1; (f) each of dbrx-132b, llama4-scout, mamba2, zamba2, hubert and
   paligemma at a cut that keeps its structure (2 layers, zamba2 one
   group and a tail, vocab 512, 4 experts; widths full) on the card
   against the CPU with the same weights (``params_from_numpy`` of the
   card's weights as numpy): logits within 0.1 of the std; the MoE
   cuts' expert-choice prefill and its combine bit-equal across two
   card calls; the SSM cuts' decode = prefill within the reference's
   tolerances (0.05, 0.12).  No kernel of phases 2-7 lies on this path.
10. Training, through ``launch.train.main`` (``Model.train_loss``,
   autograd, AdamW, the checkpoint manager, ``runtime.train``): (a) the
   100m preset (qwen3 widths, 153.0 M parameters) for 60 steps of 8 x
   256 pattern tokens; (b) gemma3-1b at full width and depth
   (999,826,048 parameters) for 10 steps of 4 x 4,096 tokens (train_4k's
   sequence past its 512-token window; reduced: global batch 256 -> 4),
   remat on.  Each prints its step time (median of steps 4 on), tokens/s,
   peak memory, the float64 kernels' share of one profiled step (the
   attention's sums, ``torch.profiler``), the host-device syncs of one
   step (``torch.cuda.set_sync_debug_mode``) and the step's operation
   bound; gates: no skipped step, finite losses, the loss falls, the
   profiler recorded device time, one sync a step.  (c) The seven
   configs of ``tests/test_torch_train_loss.py`` at 2-layer cuts, widths
   full: ``train_loss`` and every gradient leaf on the card against the
   CPU with the same weights and batch, in bf16 and in float32, at the
   CPU tests' tolerances.  (d) Exact accumulation over 2 microbatches in
   both orders gives bit-equal parameters; a checkpoint saved on the card
   restores bit for bit and resumes from its step: its losses, and the
   parameters, moments and step of its last checkpoint, equal an
   uninterrupted run's bit for bit.  No kernel of phases 2-7 lies on
   this path.
11. The mesh path (``torch.distributed`` DTensor), in spawned worlds
   (NCCL with a card a rank, else gloo with the ranks sharing the card;
   store under ``build/chip_smoke/``).  (a) One rank on a (1, 1) mesh:
   gemma3-1b at full width and depth, 3 steps of 4 x 1,024 pattern
   tokens through ``make_train_step(mesh=...)`` against the mesh-less
   step from the same init and batches: losses, parameters and AdamW
   moments bit for bit, step times and peak memory side by side.  (b) Four ranks on a (2, 2)
   ("data", "model") mesh, after a probe of the four collectives the
   step issues on CUDA tensors: gemma3-1b at full width and depth, 8
   steps of 4 x 512 tokens; gates: (i) every parameter and moment at
   ``param_specs``' placements, (ii) the first step's loss and every
   gradient (``full_tensor``) against the mesh-less step on the card,
   float32 within 1e-4 a leaf and bf16 within max(2e-2, twice the
   mesh-less bf16 gradient's own error), (iii) the ranks' losses bit
   for bit, (iv) the loss falls (the mean of the first and last 3),
   (v) one sync a step of the step's own (``set_sync_debug_mode``; the
   backend's are counted apart); it prints the step time and the
   collectives of a step (``CommDebugMode``).
   (c) The world as (1, 4): ``flash_attention_context_parallel`` at
   gemma3-1b's attention shapes (B 1, S 4,096, H 4, KV 1, hd 256, bf16),
   causal and local 512: each rank's slice equals its own
   ``flash_attention`` call bit for bit, the whole within 0.05 of the
   full attention.  (d) llama4-scout's MoE block at full width (one
   layer), ``moe_local_dispatch``, 4 x 256 tokens on (2, 2):
   ``moe_apply(mesh=)`` against one process's ``moe_apply(groups=2)`` on
   the same tokens: the router logits bit for bit (the witness that the
   routing is one process's), x + moe(x) within one ulp for each bf16
   rounding the two make apart (the routed sum, the shared expert,
   their sum, the residual's; the CPU tests' rule counts two), the
   z-loss within 1e-5.  (e) ``launch.train --model-parallel
   2`` (the 100m preset on gemma3-1b's family, 4 steps of 8 x 256) on
   the world: the launcher's (2, 2) mesh, the ranks' losses bit for bit,
   within 1e-3 of the same ``launch.train`` run mesh-less in the main
   process, the checkpoints written from the mesh.  Gloo worlds route
   the functional all-gather through c10d's (``route_gloo_all_gather``),
   so 11b-e run that routing.  No kernel of phases 2-7 lies on this
   path.
12. Serving on a mesh and the dry run.  (a) gemma2-9b at full width and
   depth with phase 8's traffic (4 slots, 32-token prompts, 16 new
   tokens) through ``ServeEngine(mesh=)`` on a (1, 1) mesh (one NCCL
   rank in this process): every prefill and decode logit and every
   token bit-equal to the mesh-less engine.  (b) A spawned 4-rank world
   (gloo on one card, under ``route_gloo_all_gather``) serving the same
   traffic on (2, 2), each rank's model drawn whole and distributed by
   ``Model.distribute_`` (depth cut to ``MESH_SERVE_LAYERS``): the ranks'
   tokens and logits bit-equal, the prefill's and first step's logits
   within 0.1 of the std past one bf16 ulp of the mesh-less engine, one
   sync a step, caches at ``cache_specs``' placements and ``cur``/``pos``
   at ``batch_spec``'s; step time, collectives a step, peak memory.
   (c) One slot with a 4,096-token prompt (s_cap 8,192, 8 steps): its
   caches' sequence split over "data", the decode's log-sum-exp merge
   held to the same rule.  (d) ``launch.dryrun.run_cell`` on four
   production cells in fake worlds of 256 and 512 ranks (a process of
   its own, alongside (a)-(c)): per-rank flops, bytes, collectives,
   roofline terms, peak bytes against 80 GiB; one cell traced again with
   ``device_type="cpu"`` gives the same counts; ``--list`` runs.  (e)
   ``launch.roofline.count_kernel_launches`` (``torch.profiler``) equals
   the launch counters and ``bank.launch_count`` on fused and
   per-instance rounds, in (d)'s process: after phase 10's profiled
   steps torch 2.11's profiler may record no device events in this one.
   No kernel of phases 2-7 lies on (a)-(d).
13. The plan-time gate on the card.  (a) ``python -m repro_torch.verify
   --smoke --device cuda`` in a subprocess exits 0, and its ``kernels``
   section holds every launch contract of its ``dataflow`` section to
   the built kernels: the launcher's ``*_launch_shape`` equals the
   declared grid, threads and dynamic shared memory, no spill bytes.
   (b) ``verify.contracts.check_bank_static`` on fake CUDA tensors for
   the kernel and fused backends of every registry design (the custom
   ops' fake versions; no launch).  (c) ``generate(name)`` of the 13
   designs, cold (the gate's caches cleared) and cached, ms a design,
   and the dataflow gate alone.  (d) One bad window in
   ``super_geometry``'s table: ``generate`` raises ``DataflowError`` and
   no kernel launches.  (e) Phase 4's rounds at B = 1,048,576 on the
   custom ops, beside their figures before, and the custom op's host cost a
   call against the raw launch it wraps.
   Phase 2's bounds are the gate's roofline of each launch's contract.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""
import ctypes
import dataclasses
import datetime
import gc
import hashlib
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

# H100 SXM peaks and the limb kernels' operation counts: the port's own
# (repro_torch/kernels/introspect.py), which the plan-time gate's
# roofline (verify/dataflow.py) uses too
from repro_torch.kernels.introspect import (  # noqa: E402
    HBM_BYTES_PER_S, ops_per_row)
from repro_torch.kernels.introspect import bound_ms as bound  # noqa: E402

SEED = 20230131
B_MAIN = 65_536          # operand pairs per design on the main path
B_TIME = 1_048_576       # operand pairs of a timed round
ORACLE_ROWS = 1_024
# gemma2-9b MLP up-projection (d_model 3584, d_ff 14336)
GEMMA_K, GEMMA_N = 3584, 14336
GEMMA_M = (2048, 64)               # a prefill chunk, a decode batch
SLICE2_KERNELS = {"prefix_adder", "karatsuba_ppm", "int8_matmul"}
COLD_BYTES = 100e6                 # twice the H100's 50 MB L2
ALL_KERNELS = {"bank_fold", "mcim_fold_fb", "mcim_fold_ff",
               "mcim_fold_karatsuba"} | SLICE2_KERNELS
ROOT = pathlib.Path(__file__).resolve().parent
REPLICAS = 2
ORACLE_SAMPLE = 65_536             # rows of a replicated round held to
#                                    the bigint oracle
GRAD_ROWS = GEMMA_K                # a (3584, 14336) float32 gradient
WORLD = 2
WORLD_LIMIT_S = 600
#: gemma2-9b train_4k: vocab, sequence, global batch
TRAIN_4K = (256_000, 4096, 256)
GEMMA2_PARAMS = 9_241_404_928      # the reference's Model.param_count()
DECODE_P0 = 64                     # decode-vs-prefill prefix (2 rows)
GEMMA3_PROMPT = 1024               # past gemma3-1b's 512-token window
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
STEP_REPEATS = 10                  # median of 10 where a step repeats
LLAMA4_LAYERS = 12                 # of 48: 57.0 GB of weights on 80 GB
SSM_PROMPT = 1000                  # 8 chunks of 128, the last padded
#: the reference's decode-consistency tolerances (smoke size)
SSM_TOL = {"mamba2-370m": 0.05, "zamba2-1.2b": 0.12}
SSM_DRIFT_GATE = 0.5               # full depth: cache faults read 1-10x
#: phase 10: the 100m preset's run through launch.train
PRESET_ARGS = ["--arch", "qwen3-32b", "--preset", "100m", "--steps", "60",
               "--seq-len", "256", "--global-batch", "8", "--source",
               "pattern", "--no-resume"]
#: gemma3-1b at train_4k's sequence; reduced: global batch 256 -> 4
GEMMA3_TRAIN = {"seq": 4096, "batch": 4, "steps": 10}
STEP_FROM = 4                      # step times: median of steps 4 on
#: kernels that compute in float64 (cuBLAS DGEMM, aten's double
#: elementwise and reduction kernels): in training only the attention's
FP64_KERNEL = re.compile(r"double|f64|d884|dgemm", re.IGNORECASE)
STEP_SYNCS = 1                     # the train step's one read of the card
#: the CPU tests' tolerances (tests/test_torch_train_loss.py)
TRAIN_LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
TRAIN_F32_GRAD_RTOL = 1e-4
TRAIN_BF16_GRAD_RTOL = 2e-2
#: phase 11: the mesh path's worlds
MESH_WORLD = 4
MESH_LIMIT_S = 480
#: gemma3-1b: 11a at (1, 1) and 11b at (2, 2) ("data", "model")
GEMMA3_MESH = {"batch": 4, "seq_a": 1024, "steps_a": 3, "seq_b": 512,
               "steps_b": 8, "layers_b": 26, "falls": 3}
#: 11c: gemma3-1b's attention shapes, one sequence of 4,096
CP_SHAPE = {"B": 1, "S": 4096, "H": 4, "KV": 1, "D": 256, "window": 512}
#: 11d: llama4-scout MoE block tokens (B, S)
LLAMA4_MESH_TOKENS = (4, 256)
#: 11e: launch.train on the (2, 2) world (--model-parallel 2) and alone
LAUNCH_MESH_ARGS = ["--arch", "gemma3-1b", "--preset", "100m", "--steps",
                    "4", "--seq-len", "256", "--global-batch", "8",
                    "--source", "pattern", "--device", "cuda", "--no-resume",
                    "--checkpoint-every", "2"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def operands(rng, shape, bits, device):
    from repro_torch.core import limbs as L
    return (L.from_numpy(L.random_limbs(rng, shape, bits), device),
            L.from_numpy(L.random_limbs(rng, shape, bits), device))


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call over ``iters`` calls launched from
    Python, CUDA events: for a short kernel, the host's cost per call."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, calls=20, replays=5):
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    per-call cost (wrapper, allocation, launch) is out of the figure."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (calls * replays)


def offset_copy(t):
    """A contiguous copy of ``t`` as many bytes off a 16-byte boundary as
    ``t`` (a plain clone would be aligned, and a path chosen by
    alignment would change)."""
    off = t.data_ptr() % 16 // t.element_size()
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    copy = flat[off:].view(t.shape)
    copy.copy_(t)
    return copy


def cold_copies(args):
    """Copies of ``args`` whose bytes together exceed :data:`COLD_BYTES`
    (at least two), each at its original's offset from 16 bytes."""
    size = sum(t.numel() * t.element_size() for t in args)
    return [tuple(offset_copy(t) for t in args)
            for _ in range(max(2, int(COLD_BYTES // size) + 1))]


def cold_graph_ms(fn, arg_sets, calls=20, replays=5):
    """Device milliseconds per call with cold operands: call i of one
    CUDA graph reads ``arg_sets[i % len(arg_sets)]`` and keeps its own
    output, so each call finds its inputs and output out of the L2."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(calls):
            outs.append(fn(*arg_sets[i % len(arg_sets)]))
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph, outs
    return start.elapsed_time(stop) / (calls * replays)


def oracle(a, b, signed=False):
    from repro_torch.core import limbs as L
    la, lb = a.shape[-1], b.shape[-1]
    out = []
    for x, y in zip(a.cpu().numpy(), b.cpu().numpy()):
        x, y = L.from_limbs(x), L.from_limbs(y)
        if signed:
            x -= (x >> (16 * la - 1)) << (16 * la)
            y -= (y >> (16 * lb - 1)) << (16 * lb)
        out.append((x * y) % (1 << (16 * (la + lb))))
    return out


def packed(x):
    """Limbs of <= 32-bit operands packed into one int64 per row."""
    x = x.reshape(-1, x.shape[-1]).to(torch.int64)
    return x[:, 0] | (x[:, 1] << 16) if x.shape[1] > 1 else x[:, 0]


# ----------------------------------------------------------------- phases

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        kernels = ptxas_report(_build.build_log(name))
        print(f"  {name}: {len(kernels)} kernels")
        for line in kernels:
            print(f"    {line}")
    lib = _build.library("int8_matmul")
    from repro_torch.kernels.int8_matmul import PATHS
    print("  int8_matmul dynamic shared memory a block: " + ", ".join(
        f"{p} {lib.int8_matmul_smem(i)} B" for i, p in enumerate(PATHS)))
    print_bulk_plans()
    return smi


def round_blocks(design_name, device):
    """The fused blocks of a B = B_TIME round of a registry design: the
    design, its per-instance op counts, rows a block and super-geometry."""
    from repro_torch import designs
    from repro_torch.kernels import bank_fold as BF
    d = designs.generate(design_name, device=device)
    n_ops = [i.n_ops for i in d.report(B_TIME).instances]
    rows, _ = BF.fused_block_rows([range(n) for n in n_ops])
    return d, n_ops, rows, BF.super_geometry(d.bank.instances, d.la, d.lb)


def print_bulk_plans():
    """The bulk kernels' shapes as the CUDA source fixes them (threads,
    tile rows, stages, dynamic shared memory) and the blocks the card
    holds of each (the persistent grid)."""
    from repro_torch.kernels import _build
    device = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for lib, symbol, widths in (
            ("bank_fold", "bank_fold_bulk_shape", (2, 4, 8, 16)),
            ("mcim_fold", "mcim_fold_bulk_shape", (2, 4, 8, 16)),
            ("karatsuba_ppm", "karatsuba_ppm_bulk_shape", (2,))):
        fn = getattr(_build.library(lib), symbol)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        for la in widths:
            info = (ctypes.c_int * 5)()
            check(fn(la, info) == 0, f"{symbol}({la}) failed")
            threads, tile, stages, smem, blocks = info
            print(f"  {symbol[:-11]} bulk kernel, {la} limbs: {threads} "
                  f"threads, {tile} rows a tile, {stages} stages, {smem} B "
                  f"shared, {blocks / sms:g} blocks an SM ({blocks} in "
                  f"the persistent grid)")


def kernel_name(mangled):
    """A short name for a mangled kernel: its identifier, the integers of
    its template arguments in brackets, and its output type if any."""
    names, i = [], 0
    while i < len(mangled):                 # length-prefixed identifiers
        digits = re.match(r"\d+", mangled[i:])
        if digits:
            i += len(digits.group())
            names.append(mangled[i:i + int(digits.group())])
            i += int(digits.group())
        else:
            i += 1
    base = next((n for n in names if n.endswith("kernel")), mangled)
    ints = re.findall(r"Li(\d+)E", mangled)
    out_t = ("bf16" if "bfloat16" in mangled else
             "f32" if f"{base}If" in mangled else "")
    return (base + (f"<{','.join(ints)}>" if ints else "")
            + (f" {out_t}" if out_t else ""))


def ptxas_report(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its short name,
    registers, static shared memory, stack and spills, and ptxas's
    warnings about it."""
    info, warns, order = {}, {}, []
    cur = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        warn = re.search(r"\((C7\d+)\) (.*) for the function '(\w+)'",
                         line)
        if warn:
            warns.setdefault(warn.group(3), []).append(
                f"{warn.group(1)} {warn.group(2)}")
        elif entry:
            cur = entry.group(1)
            order.append(cur)
            info[cur] = []
        elif cur is not None and ("spill" in line or "Used" in line):
            info[cur].append(line.split(":", 1)[-1].strip())
    return [f"{kernel_name(k)}: {'; '.join(info[k])}"
            + (f"  WARNING {' | '.join(warns[k])}" if k in warns else "")
            for k in order]


def compare(got, want):
    """(max |got - want|, bit for bit equal): float outputs compare as
    words of their width (bf16 as int16, float32 as int32)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
          f"{want.dtype}")
    if got.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
        err = (got.float() - want.float()).abs().max().item()
        return err, torch.equal(got.view(bits), want.view(bits))
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    return err, err == 0


def kernel_entry(name, route_name, source, replaces, kernel_fn, plain_fn,
                 args, contract, library=None):
    """Check a kernel against its plain version on the same inputs and
    time both (and the library call, if any).  The bound is the
    plan-time gate's roofline of the launch's contract
    (``verify.dataflow.analyze_contract``): each operand read once and
    the output written once, the kernel's integer operations; the
    contract must prove clean and declare these inputs' shapes."""
    from repro_torch.verify import dataflow
    got = kernel_fn(*args)
    want = plain_fn(*args)
    torch.cuda.synchronize()
    err, same = compare(got, want)
    check(same, f"{name}: kernel disagrees with its plain version (max "
          f"abs err {err})")
    report = dataflow.analyze_contract(contract)
    check(report.ok, f"{name}: {[v.describe() for v in report.violations]}")
    declared = [tuple(op.shape) for op in contract.operands.values()]
    check(declared[:len(args)] == [tuple(t.shape) for t in args]
          and tuple(contract.outputs["out"].shape) == tuple(got.shape),
          f"{name}: contract {contract.name} declares {declared}")
    loop_ms = cuda_ms(lambda: kernel_fn(*args), iters=20)
    ms = graph_ms(lambda: kernel_fn(*args))
    plain_ms = cuda_ms(lambda: plain_fn(*args), iters=3, warmup=1)
    lib_ms = lib_loop_ms = None
    if library is not None:
        lib_loop_ms = cuda_ms(library, iters=20)
        lib_ms = graph_ms(library)
    n_bytes, n_ops = report.hbm_bytes, report.flops
    bound_ms, bound_by = report.bound_ms, report.bound_by
    shapes = " x ".join(f"{tuple(t.shape)} {str(t.dtype)[6:]}"
                        for t in args)
    lib = ("none" if lib_ms is None else
           f"{lib_ms:.4f} ms [loop {lib_loop_ms:.4f}]")
    print(f"  {name}: {shapes}  kernel {ms:.4f} ms [loop {loop_ms:.4f}]  "
          f"plain {plain_ms:.4f} ms  library {lib}  bound "
          f"{bound_ms:.4f} ms ({bound_by}: {n_bytes} B, {n_ops} ops; "
          f"{contract.name} {contract.path}, grid {tuple(contract.grid)})"
          f"  max_abs_err {err}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "counter": route_name, "launches": None,
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def other_path(entry, run, plain_fn, args, chosen):
    """Hold the path its plan did not choose against the plain version
    on the same inputs, and time it (device time).  The operands here
    are aligned, so a plan that chose the per-thread path did so for
    the shape, which the bulk path does not take (its time: None)."""
    entry["path"] = chosen
    if chosen == "per_thread":
        entry["bulk_ms"] = None
        return
    other = "per_thread"
    err, same = compare(run(*args, path=other), plain_fn(*args))
    check(same, f"{entry['name']} {other}: disagrees with its plain "
          f"version (max abs err {err})")
    entry[f"{other}_ms"] = graph_ms(lambda: run(*args, path=other))


def add_cold(entry, kernel_fn, args, library=None, lib_args=(),
             yardstick=None):
    """Cold figures of a kernel and its library call (see
    :func:`cold_graph_ms`), beside the warm ones.  Only the cold figure
    is a share of the HBM bound: warm operands of up to ~40 MB stay in
    the L2 across replays, which moves them faster than HBM.
    ``yardstick``: (label, ms) of another lower bound, printed as a share
    beside the bound's (not part of the record)."""
    entry["ms_cold"] = cold_graph_ms(kernel_fn, cold_copies(args))
    entry["library_ms_cold"] = (None if library is None else
                                cold_graph_ms(library, cold_copies(lib_args)))
    lib = ("none" if library is None else
           f"{entry['library_ms']:.4f} ms warm, "
           f"{entry['library_ms_cold']:.4f} cold")
    share = (f"{entry['bound_ms'] / entry['ms_cold']:.1%} of the bound "
             f"({entry['bound_by']})")
    if yardstick is not None:
        label, ms = yardstick
        share += f", {ms / entry['ms_cold']:.1%} of {label} ({ms:.4f} ms)"
    path = "kernel"
    if "path" in entry:
        other = ("per_thread" if entry["path"] == "bulk" else "bulk") + "_ms"
        other_ms = ("does not take the shape" if entry[other] is None else
                    f"{entry[other]:.4f} ms warm")
        path = f"{entry['path']} path"
        lib = f"{other[:-3]} path {other_ms}; library {lib}"
    else:
        lib = f"library {lib}"
    print(f"    {path} {entry['ms']:.4f} ms warm, {entry['ms_cold']:.4f} "
          f"cold ({share} cold); {lib}")


def footprint(device, rng):
    """FF (2 limbs: 32 B a row) and the int64 ``*`` (24 B a row) warm
    over 0.5-2 million rows: the rates at which each falls out of the
    L2."""
    from repro_torch.kernels import mcim_fold as MF
    for rows in (524_288, 786_432, 1_048_576, 1_310_720, 1_572_864,
                 2_097_152):
        a, b = operands(rng, (rows,), 32, device)
        pa, pb = packed(a), packed(b)
        ff = graph_ms(lambda: MF.mcim_fold_mul(a, b, ct=2, schedule="ff"))
        lib = graph_ms(lambda: pa * pb)
        print(f"    footprint {rows} rows: FF {ff:.4f} ms "
              f"({32 * rows / ff / 1e9:.2f} TB/s), int64 * {lib:.4f} ms "
              f"({24 * rows / lib / 1e9:.2f} TB/s)")


def phase_kernels(device):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch import designs
    from repro_torch.verify import dataflow
    from repro_torch.kernels import bank_fold as BF
    from repro_torch.kernels import mcim_fold as MF
    print(f"phase 2: kernels vs plain versions, rows of a B={B_TIME} round")
    rng = np.random.default_rng(SEED)
    entries, rounds = [], {}
    src_bank = "src/repro_torch/csrc/bank_fold.cu"
    src_fold = "src/repro_torch/csrc/mcim_fold.cu"
    ref_fold = "src/repro/kernels/mcim_fold/kernel.py"

    for design_name in ("tp3p5_w32", "tp5over6_w128"):
        d, n_ops, rows, sg = round_blocks(design_name, device)
        check(d.bank.backend == "fused", f"{design_name}: auto is not fused")
        table = torch.from_numpy(sg.table()).to(device)
        a, b = operands(rng, (sg.n_instances, rows), d.spec.bits_a, device)
        contract = dataflow.round_contract(d.spec.bits_a, d.spec.bits_b,
                                           d.plan.configs, B_TIME,
                                           d.spec.scheduler)
        lib = pa = pb = None
        if d.spec.bits_a <= 32:
            pa, pb = packed(a), packed(b)
            lib = lambda pa=pa, pb=pb: pa * pb          # noqa: E731
        entry = kernel_entry(
            "bank_fold" if design_name == "tp3p5_w32"
            else f"bank_fold/{design_name}", "bank_fold", src_bank,
            "src/repro/kernels/bank_fold/kernel.py:44",
            BF.fused_bank_mul, BF.fused_bank_mul_ref, (a, b, table),
            contract, library=lib)
        other_path(entry, BF.fused_bank_mul_kernel, BF.fused_bank_mul_ref,
                   (a, b, table), BF.launch_plan(
                       sg.n_instances, rows, d.la, d.lb, True))
        add_cold(entry, BF.fused_bank_mul, (a, b, table),
                 None if lib is None else torch.mul, (pa, pb))
        entries.append(entry)
        rounds[design_name] = entry

        kd = designs.generate(dataclasses.replace(d.spec, backend="kernel"),
                              device=device)
        for cfg, n in zip(kd.bank.instances, n_ops):
            if design_name == "tp3p5_w32" and cfg.arch == "star":
                key, ct, sched, label = "mcim_fold_fb", 1, "fb", \
                    "mcim_fold_fb/star"
                line = 93
            elif design_name == "tp5over6_w128" and cfg.arch == "fb":
                key, ct, sched, label, line = ("mcim_fold_fb", cfg.ct, "fb",
                                               "mcim_fold_fb", 93)
            elif cfg.arch == "karatsuba":
                key, ct, sched, label, line = ("mcim_fold_karatsuba", 3,
                                               "karatsuba",
                                               "mcim_fold_karatsuba", 203)
            else:
                continue
            if any(e["name"] == label for e in entries):
                continue
            fa, fb_ = operands(rng, (n,), d.spec.bits_a, device)
            geo = MF.fold_geometry(d.la, d.lb, ct, sched)
            lib = pa = pb = None
            if d.spec.bits_a <= 32:
                pa, pb = packed(fa), packed(fb_)
                lib = lambda pa=pa, pb=pb: pa * pb      # noqa: E731
            run = lambda x, y, ct=ct, s=sched: MF.mcim_fold_mul(  # noqa
                x, y, ct=ct, schedule=s)
            plain = lambda x, y, ct=ct, s=sched: MF.mcim_fold_mul_ref(  # noqa
                x, y, ct=ct, schedule=s)
            # the karatsuba contract counts what its body issues
            # (KaraRows on rows of an even N); the reference's count is
            # the yardstick, as for #6
            ref_ops = n * ops_per_row(key, d.la, d.lb, ct_run=geo.ct_run,
                                      chunk=geo.chunk)
            entry = kernel_entry(
                label, key, src_fold, f"{ref_fold}:{line}", run, plain,
                (fa, fb_), MF.launch_contract(d.la, d.lb, ct, sched,
                                              batch=n), library=lib)
            if sched == "karatsuba":
                add_cold(entry, run, (fa, fb_), yardstick=(
                    "the reference's operation count", bound(0, ref_ops)[0]))
            if sched == "fb":                    # the row-tile paths
                other_path(entry, lambda x, y, path: MF.mcim_fold_kernel(
                               x, y, schedule="fb", path=path),
                           plain, (fa, fb_),
                           MF.fold_launch_plan(n, d.la, d.lb, True))
                add_cold(entry, run, (fa, fb_),
                         None if lib is None else torch.mul, (pa, pb))
            entries.append(entry)

    # ff: the strict 32-bit Table VIII point, one CT=2 instance
    d = designs.generate("tbl8_w32_strict", device=device)
    cfg = d.bank.instances[0]
    check(cfg.arch == "ff", "tbl8_w32_strict is expected to plan ff")
    fa, fb_ = operands(rng, (B_TIME,), d.spec.bits_a, device)
    pa, pb = packed(fa), packed(fb_)
    entry = kernel_entry(
        "mcim_fold_ff", "mcim_fold_ff", src_fold, f"{ref_fold}:146",
        lambda x, y: MF.mcim_fold_mul(x, y, ct=cfg.ct, schedule="ff"),
        lambda x, y: MF.mcim_fold_mul_ref(x, y, ct=cfg.ct, schedule="ff"),
        (fa, fb_), MF.launch_contract(d.la, d.lb, cfg.ct, "ff",
                                      batch=B_TIME),
        library=lambda: pa * pb)
    other_path(entry, lambda x, y, path: MF.mcim_fold_kernel(
                   x, y, schedule="ff", path=path),
               lambda x, y: MF.mcim_fold_mul_ref(x, y, ct=cfg.ct,
                                                 schedule="ff"),
               (fa, fb_), MF.fold_launch_plan(B_TIME, d.la, d.lb, True))
    add_cold(entry, lambda x, y: MF.mcim_fold_mul(x, y, ct=cfg.ct,
                                                  schedule="ff"),
             (fa, fb_), torch.mul, (pa, pb))
    footprint(device, rng)
    entries.append(entry)
    entries += slice2_entries(device, rng)
    names = {e["counter"] for e in entries}
    check(names == ALL_KERNELS, f"kernels covered: {names}")
    return entries, rounds


def gaussian_int8(gen, shape, axis, device):
    """Quantized Gaussian operands: (int8, float32 scales) along ``axis``."""
    from repro_torch.quant import quantize_rows
    x = torch.randn(shape, generator=gen, device=device)
    return quantize_rows(x, axis=axis)


def slice2_entries(device, rng):
    """The prefix adder, spatial Karatsuba and int8 matmul at the full
    shapes of their paths."""
    from repro_torch.core import limbs as L
    from repro_torch.kernels import int8_matmul as IM
    from repro_torch.kernels import karatsuba_ppm as KP
    from repro_torch.kernels import prefix_adder as PA
    entries = []
    for bits in (128, 256):
        a, b = operands(rng, (B_TIME,), bits, device)
        tag = "" if bits == 128 else f"/{bits}bit"
        cols = L.ppm(a, b)                   # (B, 2N) int64 columns
        entries.append(kernel_entry(
            f"prefix_adder{tag}", "prefix_adder",
            "src/repro_torch/csrc/prefix_adder.cu",
            "src/repro/kernels/prefix_adder/kernel.py:29",
            PA.prefix_final_adder, PA.prefix_final_adder_ref, (cols,),
            PA.launch_contract(cols.shape[1], B_TIME)))
        del cols
        n = a.shape[1]
        entry = kernel_entry(
            f"karatsuba_ppm{tag}", "karatsuba_ppm",
            "src/repro_torch/csrc/karatsuba_ppm.cu",
            "src/repro/kernels/karatsuba_ppm/kernel.py:46",
            KP.karatsuba_ppm_mul, KP.karatsuba_ppm_mul_ref, (a, b),
            KP.launch_contract(n, B_TIME))
        other_path(entry, KP.karatsuba_ppm_kernel, KP.karatsuba_ppm_mul_ref,
                   (a, b), KP.launch_plan(B_TIME, n, True))
        add_cold(entry, KP.karatsuba_ppm_mul, (a, b), yardstick=(
            "the reference's operation count",
            bound(0, B_TIME * ops_per_row("karatsuba_ppm", n, n))[0]))
        entries.append(entry)

    gen = torch.Generator(device=device).manual_seed(SEED)
    qw, sw = gaussian_int8(gen, (GEMMA_K, GEMMA_N), 0, device)
    # the library yardstick: cuBLAS int8 GEMM (int32 out, no scales) on a
    # column-major copy of w, the layout its int8 path takes
    qw_cm = qw.t().contiguous().t()
    for m in GEMMA_M:
        qx, sx = gaussian_int8(gen, (m, GEMMA_K), 1, device)
        args = (qx, qw, sx, sw)
        entry = kernel_entry(
            "int8_matmul" if m == GEMMA_M[0] else f"int8_matmul/m{m}",
            "int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
            "src/repro/kernels/int8_matmul/kernel.py:24",
            IM.int8_matmul, IM.int8_matmul_ref, args,
            IM.launch_contract(m, GEMMA_K, GEMMA_N),
            library=lambda qx=qx: torch._int_mm(qx, qw_cm))
        # the same inputs through the mma.sync kernel, on the same card
        entry["path"] = IM.kernel_path(m, GEMMA_K, GEMMA_N)
        check(entry["path"] != "mma_sync", f"M={m}: no wgmma path")
        old = lambda args=args: IM.int8_matmul_kernel(  # noqa: E731
            *args, path="mma_sync")
        err, same = compare(old(), IM.int8_matmul_ref(*args))
        check(same, f"int8 mma_sync M={m} disagrees (max abs err {err})")
        entry["mma_sync_ms"] = graph_ms(old)
        print(f"    {entry['path']} {entry['ms']:.4f} ms vs mma_sync "
              f"{entry['mma_sync_ms']:.4f} ms [loop "
              f"{cuda_ms(old, iters=20):.4f}] vs torch._int_mm "
              f"{entry['library_ms']:.4f} ms; bound {entry['bound_ms']:.4f}"
              f" ms: {entry['bound_ms'] / entry['ms']:.1%} of bound, "
              f"{entry['ms'] / entry['library_ms']:.2f}x torch._int_mm")
        entries.append(entry)

    # where kernel_path switches from decode to prefill tiles: both wgmma
    # paths on the same inputs, device times
    for m in (1, 64, 65, 128, 256, 512):
        qx, sx = gaussian_int8(gen, (m, GEMMA_K), 1, device)
        args = (qx, qw, sx, sw)
        want = IM.int8_matmul_ref(*args)
        times = {}
        for path in ("wgmma_decode", "wgmma_prefill"):
            run = lambda p=path: IM.int8_matmul_kernel(  # noqa: E731
                *args, path=p)
            check(compare(run(), want)[1], f"int8 {path} M={m} disagrees")
            times[path] = graph_ms(run)
        print(f"    M={m}: kernel_path picks "
              f"{IM.kernel_path(m, GEMMA_K, GEMMA_N)}; " + ", ".join(
                  f"{p} {t:.4f} ms" for p, t in times.items()))
    return entries


def phase_main_path(device):
    from repro_torch import designs
    from repro_torch.core.bank import Bank
    from repro_torch.core import limbs as L
    from repro_torch.kernels import _build
    from repro_torch.kernels import launch_counts, reset_launch_counts
    print(f"phase 3: main path, 13 registry designs x B={B_MAIN}")
    rng = np.random.default_rng(SEED + 1)
    inputs, plain = {}, {}

    reset_launch_counts()                       # --- fused (auto) path
    for name in designs.names():
        d = designs.generate(name)              # default device: the card
        check(d.bank.backend == "fused", f"{name}: auto gave "
              f"{d.bank.backend}")
        a, b = operands(rng, (B_MAIN,), d.spec.bits_a, device)
        before = launch_counts()["bank_fold"]
        paths_before = _build.path_counts()["bank_fold"]
        out = d.mul(a, b)
        torch.cuda.synchronize()
        launched = launch_counts()["bank_fold"] - before
        check(launched == d.bank.launch_count(B_MAIN) == 1,
              f"{name}: {launched} bank_fold launches for one round")
        path, = (p for p, n in _build.path_counts()["bank_fold"].items()
                 if n > paths_before[p])
        want = Bank(d.plan, d.spec.bits_a, d.spec.bits_b, backend="core",
                    device=device).execute(a, b)
        check(torch.equal(out, want), f"{name}: fused != plain core bank")
        check(out.shape == (B_MAIN, d.la + d.lb), f"{name}: shape")
        check(L.batch_from_limbs(out[:ORACLE_ROWS])
              == oracle(a[:ORACLE_ROWS], b[:ORACLE_ROWS]),
              f"{name}: fused != bigint oracle")
        inputs[name], plain[name] = (a, b), want
        print(f"  {name}: {d.plan.describe()}  fused ok, 1 launch "
              f"({path} path)")
    print("  fused rounds by the path they launched: "
          f"{_build.path_counts()['bank_fold']}")

    spec = dataclasses.replace(designs.get("tp3p5_w32"), signed=True)
    d = designs.generate(spec)
    a, b = operands(rng, (B_MAIN,), 32, device)
    out = d.mul(a, b)
    want = Bank(d.plan, 32, 32, backend="core", device=device).execute(a, b)
    check(d.bank.backend == "fused" and torch.equal(out, want),
          "signed tp3p5_w32: fused != plain core bank")
    check(L.batch_from_limbs(out[:ORACLE_ROWS])
          == oracle(a[:ORACLE_ROWS], b[:ORACLE_ROWS], signed=True),
          "signed tp3p5_w32: fused != bigint oracle")
    check(d.mul(-(1 << 31), 0x7FFFFFFF) == -(1 << 31) * 0x7FFFFFFF,
          "signed int mul")
    got = designs.generate("tp3p5_w32").mul(0xDEADBEEF, 0xCAFEBABE)
    check(got == 0xDEADBEEF * 0xCAFEBABE, f"int mul gave {got:#x}")
    print("  signed tp3p5_w32 fused ok; mul(0xDEADBEEF, 0xCAFEBABE) = "
          f"{got:#x}")
    fused_counts = launch_counts()
    print(f"  fused path launches: {fused_counts}")

    reset_launch_counts()                       # --- per-instance kernels
    for name in designs.names():
        spec = dataclasses.replace(designs.get(name), backend="kernel")
        if spec.signed:
            continue
        d = designs.generate(spec)
        a, b = inputs[name]
        before = sum(launch_counts().values())
        out = d.mul(a, b)
        torch.cuda.synchronize()
        launched = sum(launch_counts().values()) - before
        busy = sum(1 for i in d.report(B_MAIN).instances if i.n_ops)
        check(launched == d.bank.launch_count(B_MAIN) == busy,
              f"{name}: {launched} launches for {busy} busy instances")
        check(torch.equal(out, plain[name]), f"{name}: kernel != plain")
    kernel_counts = launch_counts()
    print(f"  kernel path launches: {kernel_counts}; FB and FF by path: "
          + ", ".join(f"{k} {v}" for k, v in _build.path_counts().items()
                      if k in ("mcim_fold_fb", "mcim_fold_ff")))
    return fused_counts, kernel_counts


def phase_rounds(device, rounds):
    from repro_torch import designs
    from repro_torch.core.bank import Bank
    print(f"phase 4: fused rounds at B={B_TIME}")
    rng = np.random.default_rng(SEED + 2)
    for name, entry in rounds.items():
        d = designs.generate(name)
        a, b = operands(rng, (B_TIME,), d.spec.bits_a, device)
        core = Bank(d.plan, d.spec.bits_a, d.spec.bits_b, backend="core",
                    device=device)
        check(torch.equal(d.mul(a, b), core.execute(a, b)),
              f"{name}: round != plain core bank")
        round_ms = cuda_ms(lambda: d.mul(a, b), iters=10)
        core_ms = cuda_ms(lambda: core.execute(a, b), iters=2, warmup=1)
        # the round's two layers: host cycle accounting (Bank.report,
        # run by every execute) and the device dispatch (gather, kernel,
        # gather back)
        t0 = time.perf_counter()
        d.bank.report(B_TIME)
        report_ms = (time.perf_counter() - t0) * 1e3
        run = d.bank.dispatch_fn(B_TIME)
        dispatch_ms = cuda_ms(lambda: run(a, b), iters=10)
        print(f"  round {name} B={B_TIME}: kernel {entry['ms']:.4f} ms  "
              f"mul round {round_ms:.4f} ms (host report {report_ms:.4f} "
              f"ms, device dispatch {dispatch_ms:.4f} ms)  plain kernel "
              f"{entry['plain_ms']:.4f} ms  plain core round "
              f"{core_ms:.4f} ms")


def phase_entry_points(device):
    """The slice-2 entry points on the card, each kernel call counted."""
    from repro_torch import quant
    from repro_torch.core import limbs as L
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.int8_matmul import int8_matmul_ref
    from repro_torch.kernels.karatsuba_ppm import kara_mul
    from repro_torch.kernels.prefix_adder import fast_final_adder
    from repro_torch.optim import compress
    print(f"phase 5: slice-2 entry points (limb paths at B={B_MAIN})")
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)

    def once(counter, fn, *args):
        before = launch_counts()[counter]
        out = fn(*args)
        torch.cuda.synchronize()
        launched = launch_counts()[counter] - before
        check(launched == 1, f"{fn.__name__}: {launched} {counter} "
              f"launches for one call")
        return out

    timed = {}              # timed after the counts are read
    reset_launch_counts()
    for bits in (128, 256):
        a, b = operands(rng, (B_MAIN,), bits, device)
        prod = once("karatsuba_ppm", kara_mul, a, b)
        check(L.batch_from_limbs(prod[:ORACLE_ROWS])
              == oracle(a[:ORACLE_ROWS], b[:ORACLE_ROWS]),
              f"kara_mul {bits}-bit != bigint oracle")
        summed = once("prefix_adder", fast_final_adder, L.ppm(a, b))
        check(torch.equal(summed, prod),
              f"fast_final_adder(ppm) {bits}-bit != kara_mul")
        print(f"  {bits}-bit: kara_mul = fast_final_adder(ppm) = oracle")

    torch.backends.cuda.matmul.allow_tf32 = False     # x @ w in full f32
    w = torch.randn((GEMMA_K, GEMMA_N), generator=gen, device=device)
    qw, sw = quant.quantize_rows(w, axis=0)
    qw_cpu, sw_cpu = quant.quantize_rows(w.cpu(), axis=0)
    check(torch.equal(qw.cpu(), qw_cpu)
          and torch.equal(sw.cpu().view(torch.int32),
                          sw_cpu.view(torch.int32)),
          "quantize_rows(w): the card's bits != the CPU's")
    print(f"  quantize_rows(w) ({GEMMA_K}, {GEMMA_N}): card = CPU bit for "
          f"bit")
    for m in GEMMA_M:
        x = torch.randn((m, GEMMA_K), generator=gen, device=device)
        got = once("int8_matmul", quant.quantized_matmul, x, w)
        qx, sx = quant.quantize_rows(x, axis=1)
        want = int8_matmul_ref(qx, qw, sx, sw)
        check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
              f"quantized_matmul M={m} != int8_matmul_ref")
        exact = x @ w
        rel = ((got.float() - exact).norm() / exact.norm()).item()
        check(rel < 0.02, f"quantized_matmul M={m}: relative error {rel}")
        print(f"  quantized_matmul ({m}, {GEMMA_K}) @ ({GEMMA_K}, "
              f"{GEMMA_N}): = plain bit for bit, relative error {rel:.5f} "
              f"vs x @ w")
        timed[f"quantized_matmul M={m}"] = \
            lambda x=x: quant.quantized_matmul(x, w)
        timed[f"  quantize_rows(x) M={m}"] = \
            lambda x=x: quant.quantize_rows(x, axis=1)
    timed["  quantize_rows(w)"] = lambda: quant.quantize_rows(w, axis=0)
    del qw, exact

    g = torch.randn((GEMMA_K, GEMMA_N), generator=gen, device=device)
    grads = {"mlp_up": g}
    qs, ss, err = compress.compress_grads(grads, compress.init_error(grads))
    back = compress.decompress_grads(qs, ss, grads)["mlp_up"]
    check(qs["mlp_up"].dtype == torch.int8 and back.shape == g.shape,
          "compress: dtype or shape")
    step = ss["mlp_up"][:, None]
    worst = ((back - g).abs() / step).max().item()
    check(worst <= 0.5 * (1 + 2**-10), f"compress: error {worst} steps")
    check(torch.equal(err["mlp_up"], g - back),
          "compress: the error buffer is not the residual")
    print(f"  compress round trip {tuple(g.shape)}: worst error {worst:.6f} "
          f"steps, error buffer = residual")
    counts = launch_counts()
    print(f"  entry-point launches: {counts}")
    timed["compress_grads + decompress_grads"] = lambda: \
        compress.decompress_grads(*compress.compress_grads(grads, err)[:2],
                                  grads)
    for label, fn in timed.items():      # CUDA events, mean of 5 calls
        print(f"  time {label}: {cuda_ms(fn, iters=5, warmup=1):.4f} ms")
    return counts


def serve_run(label, spec, reqs, device, scaler=None, **kw):
    """One serving run on the card, its launches and host time counted,
    held against the same run on the CPU.  ``scaler``: the arguments of
    a fresh ``Autoscaler`` for each run.  Returns the card's report and
    autoscaler."""
    from repro_torch import designs, serving
    from repro_torch.core import limbs
    from repro_torch.core.bank import Bank
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def autoscaler():
        return scaler and serving.Autoscaler(**scaler)

    d = designs.generate(spec, device=device)
    want_rep, want_resp = designs.generate(spec, device="cpu").serve(
        reqs, autoscaler=autoscaler(), **kw)
    card_scaler = autoscaler()
    host = {"report_s": 0.0, "execute_s": 0.0, "wait_s": 0.0,
            "copy_s": 0.0, "launches_due": 0}
    execute, report, from_numpy = Bank.execute, Bank.report, \
        limbs.from_numpy

    def timed_copy(arr, dev):          # the worker's operand copies
        t0 = time.perf_counter()
        out = from_numpy(arr, dev)
        torch.cuda.synchronize()
        host["copy_s"] += time.perf_counter() - t0
        return out

    def timed_report(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return report(self, *a, **k)
        finally:
            host["report_s"] += time.perf_counter() - t0

    def counted_execute(self, a, b):
        # the launches this round must make, then its host time (report,
        # gathers and launch enqueued) and its wait for the device (the
        # worker's copy back synchronises right after in any case)
        host["launches_due"] += self.launch_count(a.shape[0])
        t0 = time.perf_counter()
        out = execute(self, a, b)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host["execute_s"] += t1 - t0
        host["wait_s"] += time.perf_counter() - t1
        return out

    Bank.report, Bank.execute = timed_report, counted_execute
    limbs.from_numpy = timed_copy
    try:
        reset_launch_counts()
        rep, resp = d.serve(reqs, autoscaler=card_scaler, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        Bank.report, Bank.execute = report, execute
        limbs.from_numpy = from_numpy
    launched = sum(counts.values())
    check(rep.bit_exact is True and rep.n_mismatch == 0,
          f"{label}: {rep.n_mismatch} products differ from the oracle")
    check(rep.slo_violations == 0, f"{label}: {rep.slo_violations} "
          f"admitted requests missed their deadline")
    check(resp == want_resp, f"{label}: responses != the CPU run's")
    got, want = dataclasses.asdict(rep), dataclasses.asdict(want_rep)
    got.pop("wall_s"), want.pop("wall_s")
    check(got == want, f"{label}: report != the CPU run's")
    if d.bank.backend == "fused":
        check(counts["bank_fold"] == launched == rep.rounds,
              f"{label}: {counts} launches for {rep.rounds} rounds")
    else:
        check(launched == host["launches_due"] > 0,
              f"{label}: {launched} launches for {host['launches_due']} "
              f"busy instances over the rounds")
    wall_ms = rep.wall_s * 1e3
    share = {k: 100 * host[f"{k}_s"] / rep.wall_s
             for k in ("report", "execute", "wait", "copy")}
    print(f"  {label} [{d.bank.backend}, {kw.get('replicas', 1)} "
          f"replicas]: {rep.n_requests} requests, {rep.n_admitted} served, "
          f"{rep.n_refused} refused; {rep.rounds} rounds, "
          f"{launched / max(rep.rounds, 1):.2f} launches a round "
          f"({launched}); latency p50 {rep.latency_p50} p99 "
          f"{rep.latency_p99} cycles; goodput {rep.goodput:.4f}/cycle "
          f"(offered {rep.offered_rate:.4f}); wall {wall_ms:.2f} ms, "
          f"{wall_ms / max(rep.rounds, 1):.4f} ms a round: "
          f"{share['report']:.1f}% in Bank.report, "
          f"{share['execute']:.1f}% in Bank.execute (report included), "
          f"{share['wait']:.1f}% waiting for the device, "
          f"{share['copy']:.1f}% copying operands to it, the rest the "
          f"worker's host work; "
          f"steals {rep.steals}, max round {rep.max_round_batch}; "
          f"= CPU run, bit-exact")
    return rep, card_scaler


def phase_serving(device):
    """CompiledDesign.serve on the card, each run's launches counted."""
    from repro_torch import autotune, designs, serving
    print("phase 6: serving (CompiledDesign.serve, check=True)")
    signed = dataclasses.replace(designs.get("tp3p5_w32"), signed=True)
    kernel = dataclasses.replace(designs.get("tbl8_w128_strict"),
                                 backend="kernel")
    runs = (("tp3p5_w32", "tp3p5_w32"),
            ("tp5over6_w128", "tp5over6_w128"),
            ("signed tp3p5_w32", signed),
            ("tbl8_w128_strict", kernel))

    def requests(spec, n, load, seed, arrivals=serving.poisson_arrivals):
        d = designs.generate(spec, device="cpu")
        tp = float(d.plan.throughput)
        return serving.synthesize(arrivals(n, load * tp, seed=seed),
                                  d.spec.bits_a, d.spec.bits_b,
                                  budget=max(8, int(32 / tp)),
                                  seed=seed + 1)

    for k, (label, spec) in enumerate(runs):
        serve_run(label, spec, requests(spec, 2048, 0.7, SEED + 10 + k),
                  device, replicas=2, check=True)
    over, _ = serve_run("tp3p5_w32 overload", "tp3p5_w32",
                        requests("tp3p5_w32", 512, 2.5, SEED + 20), device,
                        check=True)
    check(over.n_refused > 0, "overload: no request was refused")
    d = designs.generate("tp3p5_w32", device="cpu")
    reqs = requests("tp3p5_w32", 2048, 1.2, SEED + 30,
                    arrivals=serving.diurnal_arrivals)
    rep, scaler = serve_run(
        "tp3p5_w32 diurnal", "tp3p5_w32", reqs, device,
        scaler=dict(provisioned_tp=d.plan.throughput, max_replicas=4,
                    ema=0.6, patience=2), check=True)
    check(max(n for _, n in rep.replica_timeline) > 1,
          "diurnal: the autoscaler never scaled up")
    front = autotune.search("tp3p5_w32", use_cache=False)
    rec = scaler.recommend(front)
    check(rec is None or float(rec.spec.throughput) >= scaler.rate,
          "recommend picked a design below the sustained rate")
    print(f"  autoscaler: replicas over time {rep.replica_timeline}; "
          f"{scaler.describe()}; recommends "
          f"{rec.describe() if rec else 'keeping tp3p5_w32'} "
          f"(front of {len(front)} points)")


def phase_replicas(device):
    """Replicated banks through ``generate(spec, devices=...)``, each
    round's launches counted, against the single bank and the CPU."""
    from repro_torch import designs
    from repro_torch.core import limbs as L
    from repro_torch.kernels import launch_counts, reset_launch_counts
    print(f"phase 7a: {REPLICAS} replicated banks x B={B_TIME}")
    rng = np.random.default_rng(SEED + 40)
    n_cards = torch.cuda.device_count()
    layouts = [("one card", [device] * REPLICAS)]
    if n_cards >= REPLICAS:
        layouts.append(("distinct cards", [torch.device("cuda", i)
                                           for i in range(REPLICAS)]))
    sample = torch.from_numpy(np.sort(rng.choice(
        B_TIME, ORACLE_SAMPLE, replace=False))).to(device)
    for name in ("tp3p5_w32", "tp5over6_w128"):
        base = designs.get(name)
        single = designs.generate(name)
        a, b = operands(rng, (B_TIME,), base.bits_a, device)
        want = single.mul(a, b)
        sa, sb = a[sample], b[sample]
        expect = oracle(sa, sb)
        check(L.batch_from_limbs(want[sample]) == expect,
              f"{name}: single bank != bigint oracle")
        single_ms = cuda_ms(lambda: single.mul(a, b), iters=2, warmup=1)
        for backend in ("fused", "kernel"):
            spec = dataclasses.replace(base, replicas=REPLICAS,
                                       backend=backend)
            on_cpu = designs.generate(spec, device="cpu")
            for label, devs in layouts:
                d = designs.generate(spec, devices=devs)
                reset_launch_counts()
                out = d.mul(a, b)
                torch.cuda.synchronize()
                counts = launch_counts()
                due = REPLICAS * d.bank.launch_count(B_TIME // REPLICAS)
                check(sum(counts.values()) == due > 0,
                      f"{name} {backend} x{REPLICAS} ({label}): "
                      f"{counts} launches, {due} due")
                if backend == "fused":
                    check(counts["bank_fold"] == REPLICAS,
                          f"{name}: {counts['bank_fold']} bank_fold "
                          f"launches for {REPLICAS} replicas")
                check(out.device == a.device and torch.equal(out, want),
                      f"{name} {backend} ({label}): sharded != single bank")
                check(L.batch_from_limbs(out[sample]) == expect,
                      f"{name} {backend} ({label}): != bigint oracle")
                for prop in ("throughput", "area", "peak_power_mw"):
                    check(getattr(d, prop) == getattr(on_cpu, prop),
                          f"{name}: {prop} != the CPU's")
                check(dataclasses.asdict(d.report(B_TIME))
                      == dataclasses.asdict(on_cpu.report(B_TIME)),
                      f"{name}: report != the CPU's")
                ms = cuda_ms(lambda: d.mul(a, b), iters=2, warmup=1)
                print(f"  {name} {backend} x{REPLICAS} on {label} "
                      f"{[str(x) for x in d.devices]}: = single bank = "
                      f"oracle ({ORACLE_SAMPLE} rows); launches {counts} "
                      f"({due} = {REPLICAS} x {due // REPLICAS}); "
                      f"throughput {d.throughput} = {REPLICAS} x "
                      f"{single.throughput}; sharded round {ms:.4f} ms, "
                      f"single fused round {single_ms:.4f} ms")
        try:
            designs.generate(dataclasses.replace(base,
                                                 replicas=n_cards + 1))
        except designs.DesignError as err:
            print(f"  {name} x{n_cards + 1}: refused ({err})")
        else:
            raise RuntimeError(f"{name}: {n_cards + 1} replicas on "
                               f"{n_cards} cards not refused")


def collective_rank(rank, world, init, out_path):
    """One rank of phase 7b's world; rank 0 writes the results."""
    import torch.distributed as dist
    from repro_torch.exact import exact_psum, exact_sum
    from repro_torch.optim.compress import compressed_psum, init_error
    n_cards = torch.cuda.device_count()
    dev = torch.device("cuda", rank % n_cards)
    torch.cuda.set_device(dev)
    # NCCL refuses two ranks on one card: there both ranks' CUDA tensors
    # go through gloo, which stages them through host memory
    backend = "cpu:gloo,cuda:nccl" if n_cards >= world else "gloo"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    xs = [torch.randn((GRAD_ROWS, GEMMA_N), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(
                          SEED + 50 + r)) for r in range(world)]
    x, other = xs[rank], xs[(rank + 1) % world]

    def timed(fn, *args):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    exact, exact_ms = timed(exact_psum, x)
    swapped, _ = timed(exact_psum, other)
    check(exact.device == dev and torch.equal(
        exact.view(torch.int32), swapped.view(torch.int32)),
        "exact_psum: the bits depend on the ranks' order")
    grads = {"mlp_up": x}
    (avg, err), comp_ms = timed(compressed_psum, grads, init_error(grads))
    cpu_grads = {"mlp_up": x.cpu()}
    (avg_c, err_c), comp_cpu_ms = timed(compressed_psum, cpu_grads,
                                        init_error(cpu_grads))
    check(avg["mlp_up"].device == dev, "compressed_psum left the card")
    for got, want, what in ((avg, avg_c, "mean"), (err, err_c, "error")):
        check(torch.equal(got["mlp_up"].cpu().view(torch.int32),
                          want["mlp_up"].view(torch.int32)),
              f"compressed_psum {what}: card != CPU")
    dist.barrier()
    if rank == 0:
        stacked_rows = 512           # exact_sum of the stacked inputs in
        for r0 in range(0, GRAD_ROWS, stacked_rows):   # row chunks
            want = exact_sum(torch.stack([xs[r][r0:r0 + stacked_rows]
                                          for r in range(world)]), axis=0)
            check(torch.equal(exact[r0:r0 + stacked_rows].view(torch.int32),
                              want.view(torch.int32)),
                  f"exact_psum != exact_sum (rows {r0}+)")
        rows = torch.from_numpy(np.random.default_rng(SEED + 51).choice(
            GRAD_ROWS, min(256, GRAD_ROWS), replace=False)).to(dev)
        on_cpu = exact_sum(torch.stack([xs[r][rows].cpu()
                                        for r in range(world)]), axis=0)
        check(torch.equal(exact[rows].cpu().view(torch.int32),
                          on_cpu.view(torch.int32)),
              "exact_psum != the CPU's exact_sum (sampled rows)")
        mean = sum(xs[r].double() for r in range(world)) / world
        rel = ((avg["mlp_up"].double() - mean).norm() / mean.norm()).item()
        check(rel < 0.05, f"compressed_psum: relative error {rel}")
        check(err["mlp_up"].abs().max().item() > 0,
              "compressed_psum: no residual captured")
        with open(out_path, "w") as f:
            json.dump({"backend": backend, "exact_ms": exact_ms,
                       "compressed_ms": comp_ms,
                       "compressed_cpu_ms": comp_cpu_ms, "rel": rel}, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_collectives():
    """exact_psum and compressed_psum in a spawned world of WORLD ranks."""
    import torch.multiprocessing as mp
    print(f"phase 7b: collectives, {WORLD} ranks x ({GRAD_ROWS}, {GEMMA_N}) "
          f"float32 on the card")
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    store, out = work / f"store.{os.getpid()}", work / f"world.{os.getpid()}"
    for f in (store, out):
        f.unlink(missing_ok=True)
    t0 = time.perf_counter()
    ctx = mp.spawn(collective_rank, args=(WORLD, f"file://{store}", str(out)),
                   nprocs=WORLD, join=False)
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > WORLD_LIMIT_S:
                raise RuntimeError(f"phase 7b: the world passed "
                                   f"{WORLD_LIMIT_S} s")
        wall_s = time.perf_counter() - t0
        res = json.loads(out.read_text())
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
        for f in (store, out):
            f.unlink(missing_ok=True)
    print(f"  backend {res['backend']} (tensors on the card); exact_psum "
          f"= swapped ranks = exact_sum (card, all rows; CPU, 256 rows): "
          f"{res['exact_ms']:.2f} ms; compressed_psum = CPU run bit for "
          f"bit, relative error {res['rel']:.5f} vs the float64 mean: "
          f"{res['compressed_ms']:.2f} ms (CPU copies "
          f"{res['compressed_cpu_ms']:.2f} ms); world wall {wall_s:.1f} s")


def phase_determinism(device):
    """Philox and the data sources on the card against the CPU."""
    from repro_torch import data, rng
    vocab, seq, batch = TRAIN_4K
    print(f"phase 7c: determinism path, {batch} x {seq + 1} Philox offsets, "
          f"vocab {vocab}")
    known = rng.philox4x32(torch.zeros((1, 4), dtype=torch.int64,
                                       device=device),
                           torch.zeros((1, 2), dtype=torch.int64,
                                       device=device))
    check(known[0].tolist() == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                0x9B00DBD8], "Philox known vector")
    corpus = ROOT / "build" / "chip_smoke" / f"corpus.{os.getpid()}.bin"
    corpus.parent.mkdir(parents=True, exist_ok=True)
    np.random.default_rng(SEED + 60).integers(
        0, 60_000, 2_000_000, dtype=np.uint16).tofile(corpus)
    try:
        for source in ("synthetic", "pattern", "binfile"):
            cfg = data.DataConfig(vocab_size=vocab, seq_len=seq,
                                  global_batch=batch, seed=SEED,
                                  source=source, path=str(corpus))
            t0 = time.perf_counter()
            got = data.make_source(cfg).batch_at(3)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = data.make_source(cfg, device="cpu").batch_at(3)
            cpu_s = time.perf_counter() - t0
            for k in want:
                check(got[k].dtype == want[k].dtype
                      and np.array_equal(got[k], want[k]),
                      f"{source} {k}: card != CPU")
            on_card = data.device_batch(got)
            check(all(v.device.type == device.type
                      for v in on_card.values()),
                  "device_batch left the card")
            print(f"  {source} batch_at(3) {got['tokens'].shape}: = CPU; "
                  f"{card_s * 1e3:.1f} ms (card) {cpu_s * 1e3:.1f} ms (CPU)")
    finally:
        corpus.unlink(missing_ok=True)
    offs = torch.arange(3 * batch * (seq + 1), 4 * batch * (seq + 1),
                        device=device)
    draw_ms = cuda_ms(lambda: rng.random_tokens(SEED, 1, offs, vocab),
                      iters=5, warmup=1)
    print(f"  Philox draw (random_tokens, {offs.numel()} offsets, 10 rounds "
          f"x 2 mul32x32_64 a counter): {draw_ms:.4f} ms (CUDA events); "
          f"known vector ok")


# ------------------------------------------------------------ model serving

def rel_err(got, want):
    """max|got - want| / std(want): the reference's logit tolerance."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / want.std(correction=0).clamp_min(1e-3)).item()


def rel_err_past_ulp(got, want):
    """``rel_err`` of what each element differs by past one bf16 ulp of
    ``want``: two devices' bf16 logits may round one step apart, and one
    step of a large logit (a tied embedding's logit of the token just
    read: ~40 against a std of 1.7 at paligemma-3b's width) is itself
    0.15 of the std."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(want.abs())
    ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    past = ((got - want).abs() - ulp).clamp_min(0)
    return (past.max() / want.std(correction=0).clamp_min(1e-3)).item()


def model_tokens(vocab, shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def cli_prompts(n, length, vocab):
    """The serve CLI's prompts (Philox stream 7, one per request)."""
    from repro_torch.rng import random_tokens
    return [random_tokens(7, r, torch.arange(length), vocab).numpy()
            for r in range(n)]


def event_ms(fn, n):
    """Median milliseconds of ``n`` calls, CUDA events around each call
    (host-bound work reads as its wall time)."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def decode_graph_ms(model, caches, cur, pos, replays=10):
    """Device milliseconds of one decode step: the step captured in a
    CUDA graph and replayed, so no host work sits between its kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.decode_step(caches, cur, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        model.decode_step(caches, cur, pos)
    graph.replay()
    ms = event_ms(graph.replay, replays)
    del graph
    return ms


def aten_calls(fn):
    """(all aten calls, matrix products) that ``fn`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            Count.mm += func.__name__.split(".")[0] in ("mm", "bmm")
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.calls, Count.mm


def decode_vs_prefill(model, toks, p0, s_cap):
    """max|d|/std of teacher-forced decode steps from a prefill of
    ``toks[:, :p0]``, each against a fresh prefill's last position (the
    reference's check, ``tests/test_decode_consistency.py``)."""
    b = toks.shape[0]
    caches, _ = model.prefill({"tokens": toks[:, :p0]}, s_cap=s_cap)
    errs = []
    for j in range(toks.shape[1] - p0):
        pos = torch.full((b,), p0 + j, device=toks.device)
        caches, dec = model.decode_step(caches, toks[:, p0 + j], pos)
        _, ref = model.prefill({"tokens": toks[:, :p0 + j + 1]},
                               s_cap=s_cap)
        check(bool(torch.isfinite(dec).all()), "non-finite decode logits")
        errs.append(rel_err(dec, ref))
    return errs


def decode_matches_prefill(model, toks, p0, s_cap, tol, label):
    errs = decode_vs_prefill(model, toks, p0, s_cap)
    check(max(errs) <= tol, f"{label}: decode vs prefill {errs} > {tol}")
    print(f"  {label}: decode = prefill within {tol} x std at {p0}-"
          f"{toks.shape[1] - 1} ({', '.join(f'{e:.4f}' for e in errs)})")


def served(eng, n, max_new, vocab, label):
    """The engine's outputs and traces; token ids below ``vocab`` (the
    padded vocabulary: argmax runs over every logit, as the
    reference's)."""
    check(sorted(eng.outputs) == list(range(n))
          and all(len(o) == max_new + 1 for o in eng.outputs.values())
          and all(0 <= t < vocab for o in eng.outputs.values() for t in o),
          f"{label}: outputs")
    check(eng.arrival_trace() == tuple(sorted(eng.arrival_trace()))
          and -1 not in eng.completion_trace(), f"{label}: traces")


def phase_models(device, smi):
    """The model-serving path: ``launch.serve`` over the dense models."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import build_model
    from repro_torch.models.attention import int_einsum
    print(f"phase 8: model serving (launch.serve over the dense models) "
          f"[{smi}]")
    # bf16 products accumulate in float32, as the reference's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (a) gemma2-9b at full width and depth through the CLI's main
    slots, plen, max_new = 4, 32, 16
    s_cap = plen + max_new + 8
    eng = S.main(["--arch", "gemma2-9b", "--device", str(device)])
    peak_main = torch.cuda.max_memory_allocated()
    model, vocab = eng.model, eng.model.cfg.vocab_size
    n = model.param_count()
    check(n == GEMMA2_PARAMS == sum(p.numel() for p in model.parameters()),
          f"gemma2-9b: {n} parameters")
    served(eng, 8, max_new, vocab, "gemma2-9b serve")
    ps = cli_prompts(slots, plen, vocab)
    batch = {"tokens": torch.as_tensor(np.stack(ps), device=device)}
    torch.cuda.reset_peak_memory_stats()
    _, logits = model.prefill(batch, s_cap=s_cap)
    check(logits.shape == (slots, vocab) and bool(torch.isfinite(logits)
                                                  .all()),
          "gemma2-9b prefill logits")
    prefill_ms = event_ms(lambda: model.prefill(batch, s_cap=s_cap), 5)
    timing = S.ServeEngine(model, slots, plen, s_cap)
    timing.admit_many(list(enumerate(ps)))
    check(all(timing.outputs[r][0] == eng.outputs[r][0]
              for r in range(slots)), "gemma2-9b: prefill tokens moved")
    step_ms = event_ms(timing.step, 10)
    calls, mms = aten_calls(lambda: model.decode_step(
        timing.caches, timing.cur, timing.pos))
    graph_ms = decode_graph_ms(model, timing.caches, timing.cur, timing.pos)
    peak_serve = torch.cuda.max_memory_allocated()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    kv = sum(t.numel() * t.element_size() for layer in timing.caches
             for t in layer.values())
    bound_ms = (weights + kv) / HBM_BYTES_PER_S * 1e3
    print(f"  gemma2-9b: {n:,} parameters; batched prefill {slots} x {plen} "
          f"{prefill_ms:.3f} ms (median of 5, CUDA events) [{smi}]")
    print(f"  gemma2-9b decode step, {slots} slots at s_cap {s_cap}: "
          f"{step_ms:.3f} ms eager (engine step, median of 10), "
          f"{graph_ms:.3f} ms device time (one step in a CUDA graph); "
          f"{calls} aten calls a step ({mms} matrix products) [{smi}]")
    print(f"  gemma2-9b byte bound: ({weights / 1e9:.3f} GB weights + "
          f"{kv / 1e6:.3f} MB KV cache) / 3.35 TB/s = {bound_ms:.3f} ms; "
          f"{bound_ms / step_ms:.1%} of it eager, {bound_ms / graph_ms:.1%} "
          f"in the graph; {slots * 1e3 / step_ms:.1f} tokens/s eager "
          f"[{smi}]")
    print(f"  gemma2-9b peak memory: {peak_main / 2**30:.2f} GiB through "
          f"main (init + serve), {peak_serve / 2**30:.2f} GiB while timing "
          f"[{smi}]")
    del timing
    decode_matches_prefill(model, model_tokens(vocab, (2, DECODE_P0 + 3),
                                               SEED + 80, device),
                           DECODE_P0, 2 * DECODE_P0, 0.1, "gemma2-9b")

    # (b) the int8 KV cache on the same weights
    m8 = build_model(dataclasses.replace(model.cfg, kv_cache_dtype="int8"),
                     device)
    m8.load_state_dict(model.state_dict(), assign=True)
    eng8 = S.ServeEngine(m8, slots, plen, s_cap)
    S.serve(eng8, ps, max_new)
    served(eng8, slots, max_new, vocab, "gemma2-9b int8 serve")
    c16, _ = model.prefill(batch, s_cap=s_cap)
    c8, _ = m8.prefill(batch, s_cap=s_cap)
    agree, errs, same = [], [], []
    for j in range(max_new):            # teacher-forced: the bf16 tokens
        tok = torch.tensor([eng.outputs[r][j] for r in range(slots)],
                           device=device)
        pos = torch.full((slots,), plen + j, device=device)
        c16, l16 = model.decode_step(c16, tok, pos)
        c8, l8 = m8.decode_step(c8, tok, pos)
        agree.append((l16.argmax(-1) == l8.argmax(-1)).float().mean().item())
        errs.append(rel_err(l8, l16))
        same.append(l16.argmax(-1).tolist() == [eng.outputs[r][j + 1]
                                                for r in range(slots)])
    check(np.mean(agree) >= 0.5, f"int8 cache: argmax agreement "
          f"{np.mean(agree)} < 0.5")
    int8_ms = event_ms(lambda: m8.decode_step(c8, tok, pos), 5)
    print(f"  gemma2-9b int8 KV cache: served {slots} requests; argmax "
          f"agrees with the bf16 cache on {np.mean(agree):.1%} of "
          f"{slots} x {max_new} teacher-forced rows (gate 50%); max|d|/std "
          f"{max(errs):.4f}; bf16 steps reproduce main's tokens on "
          f"{sum(same)}/{max_new}; decode step {int8_ms:.3f} ms [{smi}]")
    gen = torch.Generator(device=device).manual_seed(SEED + 81)
    kv_heads, groups, hd = 8, 2, 256
    for s in (s_cap, 4096):
        q8 = torch.randint(-127, 128, (slots, 1, kv_heads, groups, hd),
                           dtype=torch.int8, generator=gen, device=device)
        k8 = torch.randint(-127, 128, (slots, s, kv_heads, hd),
                           dtype=torch.int8, generator=gen, device=device)
        p8 = torch.randint(-127, 128, (slots, kv_heads, groups, 1, s),
                           dtype=torch.int8, generator=gen, device=device)
        for eq, a, b in (("bqkgd,bskd->bkgqs", q8, k8),
                         ("bkgqs,bskd->bqkgd", p8, k8)):
            check(torch.equal(int_einsum(eq, a, b).cpu(),
                              int_einsum(eq, a.cpu(), b.cpu())),
                  f"int8 dots {eq} at S={s}: card != CPU")
    print(f"  decode_attention_int8's integer dots (QK and PV, S = {s_cap} "
          f"and 4096): card (float64) = CPU (int64)")
    del eng, eng8, m8, model, c8, c16
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the card against the CPU: full width, 2 layers, vocab 512
    cfg2 = get_config("gemma2-9b", n_layers=2, vocab_size=512)
    card = build_model(cfg2, device).init(
        torch.Generator(device=device).manual_seed(SEED + 82))
    host = build_model(cfg2, "cpu")
    host.load_state_dict(card.state_dict())
    toks = model_tokens(512, (2, DECODE_P0 + 3), SEED + 83, device)
    errs = []
    t0 = time.perf_counter()
    runs = []
    for m, t in ((card, toks), (host, toks.cpu())):
        caches, logits = m.prefill({"tokens": t[:, :DECODE_P0]},
                                   s_cap=2 * DECODE_P0)
        out = [logits]
        for j in range(3):
            caches, logits = m.decode_step(
                caches, t[:, DECODE_P0 + j],
                torch.full((2,), DECODE_P0 + j, device=t.device))
            out.append(logits)
        runs.append(out)
    errs = [rel_err(a.cpu(), b) for a, b in zip(*runs)]
    check(max(errs) <= 0.1, f"gemma2-9b 2 layers: card vs CPU {errs}")
    print(f"  gemma2-9b full width, 2 layers, vocab 512: card = CPU within "
          f"0.1 x std, prefill and 3 decode steps ("
          f"{', '.join(f'{e:.4f}' for e in errs)}; "
          f"{time.perf_counter() - t0:.1f} s)")
    del card, host
    gc.collect()
    torch.cuda.empty_cache()

    # (d) gemma3-1b at full width, prompts past its 512-token window
    cfg3 = get_config("gemma3-1b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m3 = build_model(cfg3, device).init(
        torch.Generator(device=device).manual_seed(SEED + 84))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plen3 = GEMMA3_PROMPT
    ps3 = cli_prompts(slots, plen3, cfg3.vocab_size)
    eng3 = S.ServeEngine(m3, slots, plen3, plen3 + max_new + 8)
    t0 = time.perf_counter()
    S.serve(eng3, ps3, max_new)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served(eng3, slots, max_new, cfg3.vocab_size, "gemma3-1b serve")
    batch3 = {"tokens": torch.as_tensor(np.stack(ps3), device=device)}
    prefill3_ms = event_ms(lambda: m3.prefill(batch3, s_cap=eng3.s_cap), 3)
    step3_ms = event_ms(eng3.step, 5)
    print(f"  gemma3-1b: {m3.param_count():,} parameters, init {init_s:.3f} "
          f"s; served {slots} x {plen3}-token prompts (window "
          f"{cfg3.window}) + {max_new} new in {serve_s:.2f} s; batched "
          f"prefill {prefill3_ms:.3f} ms, decode step {step3_ms:.3f} ms, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    decode_matches_prefill(m3, model_tokens(cfg3.vocab_size,
                                            (2, plen3 + 3), SEED + 85,
                                            device),
                           plen3, eng3.s_cap, 0.05, "gemma3-1b")
    del m3, eng3
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------- the other families

def free():
    """Release the card's cached blocks; the caller drops its last
    references (``del``) first."""
    gc.collect()
    torch.cuda.empty_cache()


def built(cfg, device, seed):
    """A seeded model of ``cfg`` on ``device``: (model, init seconds)."""
    from repro_torch.models import build_model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device).init(
        torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def param_bytes(model, skip=()):
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if name.split(".")[0] not in skip)


def cache_bytes(caches):
    return sum(t.numel() * t.element_size() for c in caches
               for t in c.values())


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2**30


def step_figures(model, eng, label, bound_ms, smi, prefill_ms, plen):
    """Time ``eng``'s decode step (eager and as a CUDA graph) and print
    it beside ``bound_ms`` and the batched prefill."""
    step_ms = event_ms(eng.step, STEP_REPEATS)
    graph_ms = decode_graph_ms(model, eng.caches, eng.cur, eng.pos)
    print(f"  {label}: batched prefill {eng.slots} x {plen} "
          f"{prefill_ms:.3f} ms ({eng.slots * plen * 1e3 / prefill_ms:.0f} "
          f"tokens/s); decode step {step_ms:.3f} ms eager (median of "
          f"{STEP_REPEATS}), {graph_ms:.3f} ms as a CUDA graph; byte bound "
          f"{bound_ms:.3f} ms ({bound_ms / step_ms:.1%} eager, "
          f"{bound_ms / graph_ms:.1%} graph); "
          f"{eng.slots * 1e3 / step_ms:.1f} tokens/s eager [{smi}]")


def families_llama4(device, smi):
    """(a) llama4-scout at full width, 12 of 48 layers, through
    ``ServeEngine`` at the serve CLI's default traffic."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import api, base
    name = "llama4-scout-17b-a16e"
    cfg = get_config(name, n_layers=LLAMA4_LAYERS)
    full = base.param_count(api.template(get_config(name)))
    model, init_s = built(cfg, device, SEED + 90)
    n, vocab = model.param_count(), cfg.vocab_size
    check(n == sum(p.numel() for p in model.parameters()),
          f"{name}: parameter count")
    print(f"  {name}: {n:,} of {full:,} parameters (reduced: n_layers "
          f"48->{LLAMA4_LAYERS}; {param_bytes(model) / 1e9:.1f} GB), seeded "
          f"init {init_s:.3f} s, peak {peak_gib():.2f} GiB [{smi}]")
    slots, plen, max_new = 4, 32, 16
    s_cap = plen + max_new + 8
    eng = S.ServeEngine(model, slots, plen, s_cap)
    t0 = time.perf_counter()
    S.serve(eng, cli_prompts(8, plen, vocab), max_new)
    torch.cuda.synchronize()
    served(eng, 8, max_new, cfg.padded_vocab, f"{name} serve")
    print(f"  {name}: served 8 requests (4 slots, prompt {plen}, "
          f"{max_new} new) in {time.perf_counter() - t0:.2f} s")
    ps = cli_prompts(slots, plen, vocab)
    batch = {"tokens": torch.as_tensor(np.stack(ps), device=device)}
    prefill_ms = event_ms(lambda: model.prefill(batch, s_cap=s_cap),
                          STEP_REPEATS)
    timing = S.ServeEngine(model, slots, plen, s_cap)
    timing.admit_many(list(enumerate(ps)))
    check(all(timing.outputs[r][0] == eng.outputs[r][0]
              for r in range(slots)), f"{name}: prefill tokens moved")
    # dense token choice reads every expert: all weights but the
    # embedding (4 rows gathered), and the KV cache
    bound_ms = (param_bytes(model, skip=("embed",))
                + cache_bytes(timing.caches)) / HBM_BYTES_PER_S * 1e3
    step_figures(model, timing, name, bound_ms, smi, prefill_ms, plen)
    print(f"  {name}: peak {peak_gib():.2f} GiB")
    del timing, eng
    decode_matches_prefill(model, model_tokens(vocab, (1, plen + 3),
                                               SEED + 91, device),
                           plen, s_cap, 0.1,
                           f"{name} (token choice: 1 x {plen}-{plen + 3} "
                           f"tokens <= 4 x 16 experts)")
    errs = decode_vs_prefill(model, model_tokens(vocab, (slots, plen + 3),
                                                 SEED + 92, device),
                             plen, s_cap)
    print(f"  {name}: token-choice decode against expert-choice prefills "
          f"of {slots} x {plen + 1}-{plen + 3} tokens (C = "
          f"{slots * (plen + 1) // cfg.n_experts}-"
          f"{slots * (plen + 3) // cfg.n_experts}): max|d|/std "
          f"{', '.join(f'{e:.4f}' for e in errs)} (routing differs by "
          f"design; not gated)")
    del model
    free()


def families_ssm(device, smi, name):
    """(b, c) mamba2 / zamba2 at full width and depth, ``ServeEngine``
    with 4 prompts of 1,000 tokens; decode against a fresh prefill at
    full depth, and by depth where it passes the reference's tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import hybrid
    cfg = get_config(name)
    model, init_s = built(cfg, device, SEED + 93)
    vocab = cfg.vocab_size
    every, n_groups, n_tail = hybrid.pattern(cfg)
    reuse = (f", one shared block applied {n_groups} times"
             if cfg.shared_attn_every else "")
    print(f"  {name}: {model.param_count():,} parameters (full width and "
          f"depth: {n_groups * every + n_tail} Mamba layers{reuse}), "
          f"seeded init {init_s:.3f} s [{smi}]")
    slots, plen, max_new = 4, SSM_PROMPT, 16
    s_cap = plen + max_new + 8
    ps = cli_prompts(slots, plen, vocab)
    eng = S.ServeEngine(model, slots, plen, s_cap)
    t0 = time.perf_counter()
    S.serve(eng, ps, max_new)
    torch.cuda.synchronize()
    served(eng, slots, max_new, cfg.padded_vocab, f"{name} serve")
    print(f"  {name}: served {slots} x {plen}-token prompts + {max_new} "
          f"new in {time.perf_counter() - t0:.2f} s")
    batch = {"tokens": torch.as_tensor(np.stack(ps), device=device)}
    prefill_ms = event_ms(lambda: model.prefill(batch, s_cap=s_cap),
                          STEP_REPEATS)
    timing = S.ServeEngine(model, slots, plen, s_cap)
    timing.admit_many(list(enumerate(ps)))
    check(all(timing.outputs[r][0] == eng.outputs[r][0]
              for r in range(slots)), f"{name}: prefill tokens moved")
    # every weight but an untied embedding; the shared block once per
    # application; caches read, the SSM state and window written
    weights = param_bytes(model, skip=() if cfg.tie_embeddings
                          else ("embed",))
    if cfg.shared_attn_every:
        shared = sum(p.numel() * p.element_size()
                     for p in model.shared_attn.parameters())
        weights += (n_groups - 1) * shared
    ssm_state = sum(t.numel() * t.element_size() for c in timing.caches
                    for k, t in c.items() if k in ("conv", "state"))
    bound_ms = (weights + cache_bytes(timing.caches) + ssm_state) \
        / HBM_BYTES_PER_S * 1e3
    step_figures(model, timing, name, bound_ms, smi, prefill_ms, plen)
    print(f"  {name}: bound bytes {weights / 1e9:.3f} GB weights, "
          f"{cache_bytes(timing.caches) / 1e6:.1f} MB caches read, "
          f"{ssm_state / 1e6:.1f} MB SSM state written; peak "
          f"{peak_gib():.2f} GiB")
    del timing, eng
    toks = model_tokens(vocab, (2, plen + 3), SEED + 94, device)
    errs = decode_vs_prefill(model, toks, plen, s_cap)
    check(max(errs) < SSM_DRIFT_GATE, f"{name}: full-depth decode vs "
          f"prefill {errs} >= {SSM_DRIFT_GATE}")
    tol = SSM_TOL[name]
    print(f"  {name}: decode vs fresh prefill at full depth, 2 x {plen}-"
          f"{plen + 2}: max|d|/std {', '.join(f'{e:.4f}' for e in errs)} "
          f"(gate {SSM_DRIFT_GATE}; the reference's smoke tolerance {tol} "
          f"{'held' if max(errs) <= tol else 'exceeded'})")
    del model
    free()
    if max(errs) > tol:
        depths = ([every * g + n_tail for g in (1, 2, 4)]
                  if cfg.shared_attn_every else [1, 4, 12, 24])
        for n_layers in depths:
            cut, _ = built(get_config(name, n_layers=n_layers), device,
                           SEED + 93)
            e = decode_vs_prefill(cut, toks, plen, s_cap)
            print(f"  {name} drift by depth: {n_layers} layers, max|d|/std "
                  f"{', '.join(f'{x:.4f}' for x in e)}")
            del cut
            free()


def families_hubert(device, smi):
    """(d) hubert-xlarge's encoder forward at full width and depth."""
    from repro_torch.configs import get_config
    cfg = get_config("hubert-xlarge")
    model, init_s = built(cfg, device, SEED + 95)
    gen = torch.Generator(device=device).manual_seed(SEED + 96)
    b, t = 4, SSM_PROMPT
    frames = torch.randn((b, t, 512), generator=gen, device=device).to(
        torch.bfloat16)
    caches, logits = model.prefill({"frames": frames})
    check(caches is None and logits.shape == (b, t, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "hubert-xlarge logits")
    fwd_ms = event_ms(lambda: model.prefill({"frames": frames}),
                      STEP_REPEATS)
    mats = sum(p.numel() for p in model.parameters() if p.dim() == 2)
    flops = 2 * mats * b * t + cfg.n_layers * 4 * b * cfg.n_heads \
        * t * t * cfg.head_dim
    n_bytes = param_bytes(model) + frames.numel() * 2 + logits.numel() * 2
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  hubert-xlarge: {model.param_count():,} parameters (full "
          f"width and depth), seeded init {init_s:.3f} s; encoder_forward "
          f"of {b} x {t} frames {fwd_ms:.3f} ms (median of "
          f"{STEP_REPEATS}); bound {bound_ms:.3f} ms by "
          f"{'operations' if ops_ms >= bytes_ms else 'bytes'} "
          f"({flops / 1e12:.2f} TFLOP / 989 TFLOP/s = {ops_ms:.3f} ms; "
          f"{n_bytes / 1e9:.3f} GB / 3.35 TB/s = {bytes_ms:.3f} ms), "
          f"{bound_ms / fwd_ms:.1%} of it; peak {peak_gib():.2f} GiB [{smi}]")
    del model, logits
    free()


def families_paligemma(device, smi):
    """(e) paligemma-3b: ``vlm_prefill`` of 4 x (256 image + 32 text)
    tokens, then 16 decode steps, driven directly."""
    from repro_torch.configs import get_config
    cfg = get_config("paligemma-3b")
    model, init_s = built(cfg, device, SEED + 97)
    gen = torch.Generator(device=device).manual_seed(SEED + 98)
    b, st, max_new, nv = 4, 32, 16, cfg.n_vis_tokens
    s_cap = nv + st + max_new + 8
    image = torch.randn((b, nv, cfg.d_vis), generator=gen,
                        device=device).to(torch.bfloat16)
    toks = model_tokens(cfg.vocab_size, (b, st + max_new), SEED + 99,
                        device)

    def prefill(n_text=st):
        return model.prefill({"image_embeds": image,
                              "tokens": toks[:, :n_text]}, s_cap=s_cap)
    prefill_ms = event_ms(prefill, STEP_REPEATS)
    caches, logits = prefill()
    for j in range(max_new):           # teacher-forced
        pos = torch.full((b,), nv + st + j, device=device)
        caches, logits = model.decode_step(caches, toks[:, st + j], pos)
        check(bool(torch.isfinite(logits).all()), "paligemma-3b decode")
    _, fresh = prefill(st + max_new)
    caches, logits = prefill(st + max_new - 1)
    pos = torch.full((b,), nv + st + max_new - 1, device=device)
    tok = toks[:, st + max_new - 1]
    err = rel_err(model.decode_step(caches, tok, pos)[1], fresh)
    check(err <= 0.1, f"paligemma-3b: decode vs prefill {err} > 0.1")
    step_ms = event_ms(lambda: model.decode_step(caches, tok, pos),
                       STEP_REPEATS)
    graph_ms = decode_graph_ms(model, caches, tok, pos)
    bound_ms = (param_bytes(model) + cache_bytes(caches)) \
        / HBM_BYTES_PER_S * 1e3
    print(f"  paligemma-3b: {model.param_count():,} parameters (full width "
          f"and depth), seeded init {init_s:.3f} s; vlm_prefill {b} x "
          f"({nv} image + {st} text) {prefill_ms:.3f} ms; decode step "
          f"{step_ms:.3f} ms eager, {graph_ms:.3f} ms as a CUDA graph; byte "
          f"bound {bound_ms:.3f} ms ({bound_ms / step_ms:.1%} eager, "
          f"{bound_ms / graph_ms:.1%} graph); decode = prefill at "
          f"{nv + st + max_new} tokens within 0.1 ({err:.4f}); peak "
          f"{peak_gib():.2f} GiB [{smi}]")
    del model, caches
    free()


#: (f) the card against the CPU: arch -> (overrides, what they cut)
CUTS = {
    "dbrx-132b": (dict(n_layers=2, vocab_size=512, n_experts=4),
                  "n_layers 40->2, vocab 100352->512, experts 16->4"),
    "llama4-scout-17b-a16e": (
        dict(n_layers=2, vocab_size=512, n_experts=4),
        "n_layers 48->2, vocab 202048->512, experts 16->4"),
    "mamba2-370m": (dict(n_layers=2, vocab_size=512),
                    "n_layers 48->2, vocab 50280->512"),
    "zamba2-1.2b": (dict(n_layers=7, vocab_size=512),
                    "n_layers 38->7 (one group of 6 and a tail of 1), "
                    "vocab 32000->512"),
    "hubert-xlarge": (dict(n_layers=2), "n_layers 48->2"),
    "paligemma-3b": (dict(n_layers=2, vocab_size=512),
                     "n_layers 18->2, vocab 257216->512"),
}


def cut_run(model, family, inputs, p0):
    """Prefill and 3 teacher-forced decode steps (the encoder: its
    forward): the list of logits."""
    dev = model.device
    if family == "encoder":
        return [model.prefill({"frames": inputs["frames"].to(dev)})[1]]
    toks = inputs["tokens"].to(dev)
    batch = {k: v.to(dev) for k, v in inputs.items()}
    batch["tokens"] = toks[:, :p0]
    off = model.cfg.n_vis_tokens if family == "vlm" else 0
    caches, logits = model.prefill(batch, s_cap=2 * p0 + off)
    out = [logits]
    for j in range(toks.shape[1] - p0):
        caches, logits = model.decode_step(
            caches, toks[:, p0 + j],
            torch.full((toks.shape[0],), off + p0 + j, device=dev))
        out.append(logits)
    return out


def families_cuts(device, smi):
    """(f) each family at a cut that keeps its structure: the same
    weights on the card and on the CPU (``params_from_numpy`` of the
    card's weights as numpy), logits within 0.1 of the std; the
    expert-choice prefill and combine bit-equal across two card calls;
    the SSM's decode against a fresh prefill at the reference's
    tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, build_model, moe, params_from_numpy
    for i, (name, (over, what)) in enumerate(CUTS.items()):
        cfg = get_config(name, **over)
        card, _ = built(cfg, device, SEED + 100 + i)
        t0 = time.perf_counter()
        host = build_model(cfg, "cpu")
        host.load_state_dict(params_from_numpy(
            cfg, api.params_to_numpy(cfg, card.state_dict()), "cpu"))
        check(all(torch.equal(a.cpu(), b) for a, b in
                  zip(card.state_dict().values(),
                      host.state_dict().values())), f"{name}: weights")
        gen = torch.Generator(device=device).manual_seed(SEED + 110 + i)
        p0 = 200 if cfg.family in ("ssm", "hybrid", "encoder") else 64
        inputs = {"tokens": torch.randint(0, cfg.vocab_size, (2, p0 + 3),
                                          generator=gen, device=device)}
        if cfg.family == "encoder":
            inputs = {"frames": torch.randn((2, p0, 512), generator=gen,
                                            device=device).to(
                                                torch.bfloat16)}
        if cfg.family == "vlm":
            inputs["image_embeds"] = torch.randn(
                (2, cfg.n_vis_tokens, cfg.d_vis), generator=gen,
                device=device).to(torch.bfloat16)
        got = cut_run(card, cfg.family, inputs, p0)
        t1 = time.perf_counter()
        want = cut_run(host, cfg.family, {key: v.cpu() for key, v in
                                          inputs.items()}, p0)
        cpu_s = time.perf_counter() - t1
        errs = [rel_err(a.cpu(), b) for a, b in zip(got, want)]
        past = [rel_err_past_ulp(a.cpu(), b) for a, b in zip(got, want)]
        check(max(past) <= 0.1, f"{name} cut: card vs CPU {past} past one "
              f"ulp ({errs})")
        extra = ""
        if cfg.family == "moe":        # expert choice: 2 x 64 > 4 x 4
            again = cut_run(card, cfg.family, inputs, p0)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name}: two card calls differ")
            t = 2 * p0
            idx = torch.stack([torch.randperm(t, generator=gen,
                                              device=device)
                               for _ in range(cfg.n_experts)])
            y = torch.randn((cfg.n_experts, t, cfg.d_model), generator=gen,
                            device=device).to(torch.bfloat16)
            check(torch.equal(moe._group_combine(y[None], idx[None], t),
                              moe._group_combine(y[None], idx[None], t)),
                  f"{name}: expert-choice combine differs between calls")
            extra = (f"; prefill logits and the combine of {cfg.n_experts}"
                     f" x {t} rows (every token from every expert) "
                     f"bit-equal across two card calls")
        if cfg.family in ("ssm", "hybrid"):
            errs_d = decode_vs_prefill(card, inputs["tokens"], p0, 2 * p0)
            tol = SSM_TOL[name]
            check(max(errs_d) <= tol, f"{name} cut: decode vs prefill "
                  f"{errs_d} > {tol}")
            extra = (f"; decode = prefill within {tol} on the card ("
                     f"{', '.join(f'{e:.4f}' for e in errs_d)})")
        print(f"  {name} cut ({what}; widths full): "
              f"{card.param_count():,} parameters; card = CPU within 0.1 "
              f"x std past one bf16 ulp ({', '.join(f'{e:.4f}' for e in past)}"
              f"; max|d|/std {', '.join(f'{e:.4f}' for e in errs)}; CPU "
              f"{cpu_s:.1f} s, {time.perf_counter() - t0:.1f} s with the "
              f"copy){extra}")
        del card, host, got, want
        free()


def phase_families(device, smi):
    """The other model families on the card: moe, ssm, hybrid, encoder
    and vlm, each freed before the next is built."""
    print(f"phase 9: the other model families (moe, ssm, hybrid, encoder, "
          f"vlm) [{smi}]")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    free()
    t0 = time.perf_counter()
    families_llama4(device, smi)
    for name in ("mamba2-370m", "zamba2-1.2b"):
        families_ssm(device, smi, name)
    families_hubert(device, smi)
    families_paligemma(device, smi)
    families_cuts(device, smi)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- phase 10

#: phase 10 (c): the seven configs of the CPU parity tests at 2-layer
#: cuts, widths full (phase 9's cuts and two dense ones)
TRAIN_CUTS = {
    "qwen3-32b": (dict(n_layers=2, vocab_size=512),
                  "n_layers 64->2, vocab 151936->512"),
    "gemma2-9b": (dict(n_layers=2, vocab_size=512),
                  "n_layers 42->2 (one local/global group), vocab "
                  "256000->512"),
    **{name: CUTS[name] for name in (
        "llama4-scout-17b-a16e", "mamba2-370m", "zamba2-1.2b",
        "hubert-xlarge", "paligemma-3b")},
}


def unmasked_pairs(kind, s, window):
    """Query-key pairs a (sequence, head) attends: causal, or causal
    within ``window`` (local)."""
    if kind == "local":
        w = min(window, s)
        return w * (w + 1) // 2 + (s - w) * w
    return s * (s + 1) // 2


def matmul_params(cfg):
    """Parameters that enter a matrix product: every matrix but an
    untied embedding (a lookup); a tied one is the unembedding."""
    from repro_torch.models import api
    return sum(int(np.prod(p.shape)) for name, _, _, p in
               api.param_layout(cfg) if len(p.shape) >= 2
               and (name != "embed" or cfg.tie_embeddings))


def train_bound(cfg, batch, seq):
    """(ms, operations) of a dense LM's train step at the bf16 peak: 3 x
    (2 x matmul parameters x tokens + the attention's 4 B H hd x
    unmasked pairs); remat's second forward is not counted."""
    from repro_torch.models import transformer as T
    attn = sum(4 * batch * cfg.n_heads * cfg.head_dim
               * unmasked_pairs(kind, seq, cfg.window)
               for kind in T.layer_kinds(cfg))
    ops = 3 * (2 * matmul_params(cfg) * batch * seq + attn)
    return ops / BF16_FLOPS * 1e3, ops


def pattern_batch(cfg, batch, seq, device):
    """Step 0 of the pattern source, on ``device``."""
    from repro_torch.data import DataConfig, device_batch, make_source
    src = make_source(DataConfig(cfg.vocab_size, seq, batch,
                                 source="pattern"), device=device)
    return device_batch(src.batch_at(0), device)


def profiled_step(cfg, device, batch, seed):
    """(float64 kernels' ms, all kernels' ms, syncs, seconds taken) of
    train steps of a fresh model after a warm step: one under
    ``torch.profiler`` (device activity only), one listing the
    synchronizing CUDA calls ``set_sync_debug_mode("warn")`` reports
    (``syncs``: each call's Python file:line)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime import make_train_step
    model, _ = built(cfg, device, seed)
    step = make_train_step(model, AdamWConfig())
    state = init_state(dict(model.named_parameters()))
    t0 = time.perf_counter()
    step(state, batch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    f64 = sum(e.self_device_time_total for e in kernels
              if FP64_KERNEL.search(e.key)) / 1e3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        caught.clear()           # turning the mode on may warn once
        try:
            step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchronizing" in str(w.message)]
    del model, state, step, prof
    free()
    return f64, total, syncs, time.perf_counter() - t0


def training_run(label, argv, cfg, batch, seq, device, smi, seed, falls):
    """``launch.train.main(argv)`` into a temporary checkpoint
    directory: gates (no skipped step, finite losses, ``falls`` over the
    first and last ``falls`` losses) and figures; then one profiled step
    of a fresh model for the float64 kernels' share."""
    from repro_torch.launch import train as LT
    free()
    torch.cuda.reset_peak_memory_stats()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = tempfile.mkdtemp(dir=work)
    t0 = time.perf_counter()
    try:
        res = LT.main(argv + ["--checkpoint-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    peak = peak_gib()
    losses = res.losses
    first, last = np.mean(losses[:falls]), np.mean(losses[-falls:])
    check(res.skipped_steps == 0 and np.isfinite(losses).all(),
          f"{label}: skipped {res.skipped_steps}, losses {losses}")
    check(last < first, f"{label}: loss did not fall ({losses})")
    steps = res.step_seconds[STEP_FROM:]
    step_ms = statistics.median(steps) * 1e3
    bound_ms, ops = train_bound(cfg, batch, seq)
    f64_ms, kern_ms, syncs, prof_s = profiled_step(
        cfg, device, pattern_batch(cfg, batch, seq, device), seed)
    check(kern_ms > 0, f"{label}: the profiler recorded no device time")
    check(len(syncs) == STEP_SYNCS, f"{label}: {len(syncs)} syncs in a "
          f"train step ({', '.join(syncs)}), expected {STEP_SYNCS}")
    print(f"  {label}: {res.final_step} steps of {batch} x {seq} tokens; "
          f"step {step_ms:.1f} ms (median of steps {STEP_FROM}-"
          f"{res.final_step - 1}; {min(steps) * 1e3:.1f}-"
          f"{max(steps) * 1e3:.1f}), {batch * seq * 1e3 / step_ms:,.0f} "
          f"tokens/s; loss {first:.4f} -> {last:.4f} (mean of the first "
          f"and last {falls}); peak {peak:.2f} GiB; float64 kernels "
          f"(flash_attention's sums) {f64_ms:.1f} of {kern_ms:.1f} ms of "
          f"kernel time in a profiled step ({f64_ms / kern_ms:.1%}; "
          f"{f64_ms / step_ms:.1%} of the step); {len(syncs)} sync a step "
          f"({', '.join(syncs)}); "
          f"bound {bound_ms:.3f} ms "
          f"({ops:.4e} operations), {bound_ms / step_ms:.1%} of the step; "
          f"main() {wall:.1f} s with init and checkpoints, the profiled "
          f"step {prof_s:.1f} s with its warm step [{smi}]")
    return res


def train_inputs(cfg, gen, device):
    """A (2, 64) batch of ``cfg``'s family drawn on ``device``."""
    b, s = 2, 64
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=device)
    if cfg.family == "encoder":
        return {"frames": torch.randn((b, s, 512), generator=gen,
                                      device=device).to(torch.bfloat16),
                "mask": torch.rand((b, s), generator=gen,
                                   device=device) < 0.3,
                "labels": labels}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=device),
             "labels": labels,
             "mask": (torch.rand((b, s), generator=gen, device=device)
                      < 0.9).to(torch.float32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (b, cfg.n_vis_tokens, cfg.d_vis), generator=gen,
            device=device).to(torch.bfloat16)
    return batch


def loss_and_grads(model, batch):
    """(loss, {name: float32 CPU gradient}) of ``model.train_loss``."""
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    loss = model.train_loss({k: v.to(model.device)
                             for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), {n: g.to(torch.float32).cpu()
                                  for n, g in zip(names, grads)}


def rel_l2(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-12)).item()


def training_cuts(device, smi):
    """(c) each config of the CPU tests at a 2-layer cut, the same
    weights and batch on the card and on the CPU, in bf16 and then in
    float32: the loss and every gradient leaf within the CPU tests'
    tolerances, the CPU's float32 gradients standing as the truth."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, build_model, params_from_numpy
    for i, (name, (over, what)) in enumerate(TRAIN_CUTS.items()):
        t_cut = time.perf_counter()
        cfg = get_config(name, **over)
        card, _ = built(cfg, device, SEED + 200 + i)
        host = build_model(cfg, "cpu")
        host.load_state_dict(params_from_numpy(
            cfg, api.params_to_numpy(cfg, card.state_dict()), "cpu"))
        gen = torch.Generator(device=device).manual_seed(SEED + 210 + i)
        batch = train_inputs(cfg, gen, device)
        runs, cpu_s = {}, 0.0
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32:
                card.float()
                host.float()
            got = loss_and_grads(card, batch)
            t0 = time.perf_counter()
            want = loss_and_grads(host, {k: v.cpu()
                                         for k, v in batch.items()})
            cpu_s += time.perf_counter() - t0
            check(np.isfinite(got[0]) and abs(got[0] - want[0])
                  <= TRAIN_LOSS_RTOL[dtype] * abs(want[0]),
                  f"{name} cut {dtype}: loss {got[0]} vs CPU {want[0]}")
            runs[dtype] = got, want
        truth = runs[torch.float32][1][1]
        errs = {n: (rel_l2(runs[torch.float32][0][1][n], truth[n]),
                    rel_l2(runs[torch.bfloat16][0][1][n], truth[n]),
                    rel_l2(runs[torch.bfloat16][1][1][n], truth[n]))
                for n in truth}
        median_own = float(np.median([e[2] for e in errs.values()]))
        bad = {n: e for n, e in errs.items()
               if not (e[0] <= TRAIN_F32_GRAD_RTOL and e[1] <= max(
                   TRAIN_BF16_GRAD_RTOL, 2 * e[2], 2 * median_own))}
        check(not bad, f"{name} cut: gradients {bad}")
        worst = max(errs, key=lambda n: errs[n][1] / max(
            TRAIN_BF16_GRAD_RTOL, 2 * errs[n][2], 2 * median_own))
        print(f"  {name} cut ({what}; widths full): {card.param_count():,} "
              f"parameters; loss card {runs[torch.bfloat16][0][0]:.5f} / "
              f"CPU {runs[torch.bfloat16][1][0]:.5f} (bf16), "
              f"{runs[torch.float32][0][0]:.6f} / "
              f"{runs[torch.float32][1][0]:.6f} (float32); {len(errs)} "
              f"gradient leaves: float32 card vs CPU at most "
              f"{max(e[0] for e in errs.values()):.2e}; bf16 card vs the "
              f"CPU's float32 at most {max(e[1] for e in errs.values()):.4f}"
              f" (worst against its bound: {worst} {errs[worst][1]:.4f}, "
              f"the CPU's own bf16 {errs[worst][2]:.4f}, median "
              f"{median_own:.4f}); CPU {cpu_s:.1f} s, "
              f"{time.perf_counter() - t_cut:.1f} s with the card and the "
              f"copies")
        del card, host, runs, truth
        free()


def training_bits(device, smi):
    """(d) exact accumulation over 2 microbatches in both orders, and a
    checkpoint written on the card restored and resumed."""
    t0 = time.perf_counter()
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten_with_names
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch.train import PRESET_100M
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime import TrainerConfig, make_train_step, train
    from repro_torch.runtime import trainer as TR
    cfg = dataclasses.replace(get_config("qwen3-32b"), **PRESET_100M)
    batch = pattern_batch(cfg, 8, 256, device)
    runs = []
    for perm in (list(range(8)), [4, 5, 6, 7, 0, 1, 2, 3]):
        model, _ = built(cfg, device, SEED + 300)
        step = make_train_step(model, AdamWConfig(), microbatches=2,
                               exact_accum=True)
        stats = step(init_state(dict(model.named_parameters())),
                     {k: v[perm] for k, v in batch.items()})
        runs.append((stats["loss"], [p.detach().clone()
                                     for p in model.parameters()]))
        del model, step
        free()
    check(runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])),
        "exact_accum: microbatch order changed the parameters")
    del runs
    opt = AdamWConfig(warmup_steps=1, total_steps=6)
    src = make_source(DataConfig(cfg.vocab_size, 256, 8, source="pattern"),
                      device=device)
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    ckpt, ckpt_full = tempfile.mkdtemp(dir=work), tempfile.mkdtemp(dir=work)
    try:
        trained = build_model(cfg, device)
        res = train(trained, src, opt, TrainerConfig(
            steps=4, checkpoint_every=2, checkpoint_dir=ckpt, log_every=0),
            resume=False, seed=SEED + 301)
        mgr = CheckpointManager(ckpt)
        check(res.final_step == 4 and mgr.all_steps() == [2, 4],
              f"checkpoints {mgr.all_steps()} after {res.final_step} steps")
        fresh = build_model(cfg, device)
        state = init_state(dict(fresh.named_parameters()))
        TR.load_state(fresh, state, mgr.restore(4, TR._like_tree(cfg),
                                                device))
        check(int(state["step"]) == 4 and all(
            torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                              trained.parameters())),
            "checkpoint: restored parameters differ from the trained")
        del fresh, state, trained
        resumed = train(build_model(cfg, device), src, opt, TrainerConfig(
            steps=6, checkpoint_every=0, checkpoint_dir=ckpt, log_every=0))
        check(resumed.final_step == 6 and len(resumed.losses) == 2,
              f"resume: {resumed.final_step}, {resumed.losses}")
        whole = train(build_model(cfg, device), src, opt, TrainerConfig(
            steps=6, checkpoint_every=0, checkpoint_dir=ckpt_full,
            log_every=0), resume=False, seed=SEED + 301)
        check(resumed.losses == whole.losses[4:],
              f"resume: steps 4-5 {resumed.losses} vs {whole.losses[4:]}")
        like = TR._like_tree(cfg)
        ends = [CheckpointManager(d).restore(6, like)
                for d in (ckpt, ckpt_full)]
        leaves = [dict(_flatten_with_names(t)) for t in ends]
        differ = [n for n in leaves[1] if not torch.equal(leaves[0][n],
                                                          leaves[1][n])]
        check(not differ, f"resume: step 6 differs from an uninterrupted "
              f"run's in {differ[:5]} ({len(differ)} leaves)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(ckpt_full, ignore_errors=True)
    print(f"  bits (100m preset, 8 x 256): exact_accum over 2 microbatches "
          f"gives bit-equal parameters in both orders; a checkpoint at step "
          f"4 restores bit for bit and resumes at step 4: steps 4-5 "
          f"{', '.join(f'{v:.6f}' for v in resumed.losses)} and the step-6 "
          f"checkpoint ({len(leaves[0])} leaves: parameters, moments, step) "
          f"equal an uninterrupted run's bit for bit; "
          f"{time.perf_counter() - t0:.1f} s)")
    free()


def phase_training(device, smi):
    """The training path: ``launch.train`` (Model.train_loss, autograd,
    AdamW, the checkpoint manager, the trainer loop) on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import PRESET_100M
    print(f"phase 10: training (launch.train over runtime.train) [{smi}]")
    t0 = time.perf_counter()
    preset = dataclasses.replace(get_config("qwen3-32b"), **PRESET_100M)
    training_run("(a) qwen3 100m preset, 153.0 M parameters", PRESET_ARGS,
                 preset, 8, 256, device, smi, SEED + 400, falls=5)
    g = GEMMA3_TRAIN
    gemma3 = get_config("gemma3-1b")
    training_run(
        f"(b) gemma3-1b, full width and depth (reduced: global batch "
        f"256->{g['batch']}), remat on",
        ["--arch", "gemma3-1b", "--steps", str(g["steps"]), "--seq-len",
         str(g["seq"]), "--global-batch", str(g["batch"]), "--source",
         "pattern", "--no-resume", "--checkpoint-every", "0"],
        gemma3, g["batch"], g["seq"], device, smi, SEED + 401, falls=3)
    print("  (c) card = CPU, loss and gradients")
    training_cuts(device, smi)
    training_bits(device, smi)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")


def mesh_backend(world):
    """NCCL with a card a rank; else gloo, the ranks sharing card 0 (NCCL
    refuses two ranks on one card; gloo stages CUDA tensors through host
    memory)."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


_GLOO_ROUTE = []


def route_gloo_all_gather():
    """torch 2.11's gloo backend segfaults in the coalesced all-gather
    that the functional ``all_gather_into_tensor`` (DTensor's Shard ->
    Replicate) runs on CUDA tensors, while c10d's own
    ``all_gather_into_tensor`` on the same tensors works
    (``scripts/gloo_cuda_probe.py``): route the functional op's CUDA
    kernel through the latter.
    Only for gloo with the ranks sharing a card; NCCL needs nothing."""
    import torch.distributed as dist

    def gather(local, group_size, group_name):
        group = dist.distributed_c10d._resolve_process_group(group_name)
        out = local.new_empty((local.shape[0] * group_size,
                               *local.shape[1:]))
        dist.all_gather_into_tensor(out, local.contiguous(), group=group)
        return out
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    _GLOO_ROUTE.append(lib)            # the registration lives with it


def mesh_rank(rank, world, init, out_path, part):
    """One rank of phase 11's worlds: ``part`` "a" (one rank) or "bcde"
    (four); rank 0 writes the results as JSON."""
    import torch.distributed as dist
    n_cards = torch.cuda.device_count()
    dev = torch.device("cuda", rank % n_cards)
    torch.cuda.set_device(dev)
    backend = mesh_backend(world)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_LIMIT_S))
    if backend == "gloo":
        route_gloo_all_gather()
    try:
        res = {"backend": backend, "parts_s": {}}
        parts = [mesh_one_rank] if part == "a" else [
            mesh_probe, mesh_train, mesh_context_parallel,
            mesh_local_experts, mesh_launch_train]
        for fn in parts:
            t0 = time.perf_counter()
            fn(dev, rank, world, res)
            res["parts_s"][fn.__name__] = time.perf_counter() - t0
            if rank == 0:           # progress, should a later part fail
                print(f"  [{fn.__name__}: {res['parts_s'][fn.__name__]:.1f}"
                      f" s]", flush=True)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh_steps(model, opt, batches, mesh=None):
    """(losses, per-step seconds, AdamW state, step function) of
    ``make_train_step`` over ``batches`` from a fresh AdamW state."""
    import torch.distributed as dist
    from repro_torch.data import device_batch
    from repro_torch.optim import init_state
    from repro_torch.runtime import make_train_step
    step = make_train_step(model, opt, mesh=mesh)
    state = init_state(dict(model.named_parameters()))
    losses, seconds = [], []
    for b in batches:
        if mesh is not None:
            b = device_batch(b, mesh=mesh)
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, b)["loss"])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, state, step


def mesh_one_rank(dev, rank, world, res):
    """11a: gemma3-1b at full width and depth on a (1, 1) mesh against
    the mesh-less step from the same init and batches."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamWConfig
    g = GEMMA3_MESH
    cfg = get_config("gemma3-1b")
    src = make_source(DataConfig(cfg.vocab_size, g["seq_a"], g["batch"],
                                 source="pattern"), device=dev)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                src.batch_at(i).items()} for i in range(g["steps_a"])]
    opt = AdamWConfig(warmup_steps=1, total_steps=10)
    plain, _ = built(cfg, dev, SEED + 500)
    torch.cuda.reset_peak_memory_stats()
    p_loss, p_sec, p_state, _ = mesh_steps(plain, opt, batches)
    p_peak = peak_gib()
    meshed, _ = built(cfg, dev, SEED + 500)
    mesh = make_host_mesh(1)
    torch.cuda.reset_peak_memory_stats()
    m_loss, m_sec, m_state, _ = mesh_steps(meshed, opt, batches, mesh)
    m_peak = peak_gib()

    def same(a, b):
        a = a.to_local() if hasattr(a, "to_local") else a
        return torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    differ, worst = [], 0.0
    pairs = [(n, p, dict(plain.named_parameters())[n])
             for n, p in meshed.named_parameters()]
    pairs += [(f"{k}/{n}", m_state[k][n], p_state[k][n]) for k in ("m", "v")
              for n in p_state[k]]
    for name, a, b in pairs:
        if not same(a, b):
            differ.append(name)
            worst = max(worst, rel_l2(a.to_local().float(), b.float()))
    res.update(a_losses=[m_loss, p_loss], a_seconds=[m_sec, p_sec],
               a_peak=[m_peak, p_peak], a_leaves=len(pairs),
               a_differ=differ, a_worst=worst,
               a_params=meshed.param_count())


def mesh_probe(dev, rank, world, res):
    """The collectives the DTensor step issues, on CUDA tensors over this
    world's backend; a missing one fails the phase."""
    import torch.distributed as dist
    x = torch.arange(8, dtype=torch.float32, device=dev) + dist.get_rank()
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=dev), x),
        "reduce_scatter": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device=dev), x),
        "all_to_all": lambda: dist.all_to_all_single(
            torch.empty(8, device=dev), x),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:            # recorded, then the phase fails
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
    res["probe"] = out
    check(all(v == "ok" for v in out.values()),
          f"phase 11: collectives on CUDA tensors: {out}")


def mesh_grads(model, batch, mesh=None):
    """(loss, {name: float32 full gradient}) of ``train_loss``."""
    from repro_torch.data import device_batch
    from repro_torch.optim.adamw import placed_like
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    b = batch if mesh is None else device_batch(batch, mesh=mesh)
    loss = model.train_loss(b, mesh)
    grads = torch.autograd.grad(loss, list(named.values()))
    if mesh is not None:
        grads = [g.full_tensor() for g in placed_like(
            named, dict(zip(named, grads))).values()]
    return float(loss), {n: g.float() for n, g in zip(named, grads)}


def mesh_train(dev, rank, world, res):
    """11b: gemma3-1b at full width on a (2, 2) mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, device_batch, make_source
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.base import placements
    from repro_torch.optim import AdamWConfig
    g = GEMMA3_MESH
    cfg = get_config("gemma3-1b", n_layers=g["layers_b"])
    mesh = make_host_mesh(2)
    src = make_source(DataConfig(cfg.vocab_size, g["seq_b"], g["batch"],
                                 source="pattern"), device=dev)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                src.batch_at(i).items()} for i in range(g["steps_b"])]
    t0 = time.perf_counter()
    # (ii) the first step's loss and gradients, float32 and bf16
    grads = {}
    for tag in ("f32", "bf16"):
        model = build_model(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(SEED + 501))
        if tag == "f32":
            model.float()
        model.distribute_(mesh)
        grads[tag] = mesh_grads(model, batches[0], mesh)
        del model
        free()
        if rank == 0:
            model = build_model(cfg, dev).init(
                torch.Generator(device=dev).manual_seed(SEED + 501))
            if tag == "f32":
                model.float()
            grads["plain_" + tag] = mesh_grads(model, batches[0])
            del model
            free()
    if rank == 0:
        truth = grads["plain_f32"][1]
        errs = {}
        for n, t in truth.items():
            errs[n] = (rel_l2(grads["f32"][1][n], t),
                       rel_l2(grads["bf16"][1][n], t),
                       rel_l2(grads["plain_bf16"][1][n], t))
        res["b_grad"] = {
            "losses": {k: v[0] for k, v in grads.items()},
            "f32_worst": max(errs.items(), key=lambda kv: kv[1][0]),
            "bf16_bad": [(n, e) for n, e in errs.items()
                         if e[1] > max(TRAIN_BF16_GRAD_RTOL, 2 * e[2])],
            "bf16_worst_ratio": max(e[1] / max(TRAIN_BF16_GRAD_RTOL,
                                               2 * e[2])
                                    for e in errs.values()),
            "leaves": len(errs)}
    del grads
    free()
    grad_s = time.perf_counter() - t0
    # the training run: placements (i), bits across ranks (iii), the
    # loss falls (iv), one sync a step (v), the collectives of a step
    model = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED + 502))
    torch.cuda.reset_peak_memory_stats()
    # at 2,048 tokens a step the full vocabulary's loss moves little: a
    # warm-up to 1e-3 and a cosine over the run, judged as phase 10
    # judges (the mean of the first and the last steps)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=g["steps_b"])
    losses, seconds, state, step = mesh_steps(model, opt, batches, mesh)
    peak = peak_gib()
    specs = model.param_specs(mesh)
    placed = all(p.placements == placements(specs[n], mesh)
                 and state["m"][n].placements == p.placements
                 and state["v"][n].placements == p.placements
                 for n, p in model.named_parameters())
    n_sharded = sum(any(pl.is_shard() for pl in p.placements)
                    for p in model.parameters())
    everyone = [None] * world
    dist.all_gather_object(everyone, losses)
    b = device_batch(batches[0], mesh=mesh)
    comm = CommDebugMode()
    with comm:
        step(state, b)
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        caught.clear()
        try:
            step(state, b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    # the step's own reads, apart from the backend's (gloo stages CUDA
    # tensors through the host inside torch.distributed)
    own = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in syncs
           if f"{os.sep}distributed{os.sep}" not in w.filename]
    syncs = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in syncs]
    res.update(b_losses=everyone, b_seconds=seconds, b_peak=peak,
               b_placed=placed, b_sharded=n_sharded,
               b_leaves=len(specs), b_comm=counts, b_syncs=syncs,
               b_own_syncs=own, b_grad_s=grad_s,
               b_params=model.param_count())
    del model, state, step
    free()


def mesh_context_parallel(dev, rank, world, res):
    """11c: context-parallel attention at gemma3-1b's attention shapes on
    the world reshaped to (1, 4)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.attention import (
        flash_attention, flash_attention_context_parallel)
    from repro_torch.models.base import distribute, placements
    c = CP_SHAPE
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 503)
    q = torch.randn((c["B"], c["S"], c["H"], c["D"]), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((c["B"], c["S"], c["KV"], c["D"]), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    whole = placements((None,) * 4, mesh)
    s_loc, off = c["S"] // world, rank * (c["S"] // world)
    out = {}
    for kind, window in (("causal", None), ("local", c["window"])):
        kw = dict(mask_kind=kind, window=window, q_chunk=512, k_chunk=512)
        o = flash_attention_context_parallel(
            distribute(q, mesh, whole), distribute(k, mesh, whole),
            distribute(v, mesh, whole), mesh, **kw)
        cp_ms = event_ms(lambda: flash_attention_context_parallel(
            distribute(q, mesh, whole), distribute(k, mesh, whole),
            distribute(v, mesh, whole), mesh, **kw), 3)
        k_off, klen = 0, c["S"]
        if kind == "local":
            klen = min(c["S"], s_loc + -(-window // 512) * 512)
            k_off = min(max(off + s_loc - klen, 0), c["S"] - klen)
        mine = flash_attention(
            q[:, off:off + s_loc], k[:, k_off:k_off + klen],
            v[:, k_off:k_off + klen], mask_kind=kind, window=window,
            q_chunk=min(512, s_loc), k_chunk=512, schedule="masked",
            q_offset=off, k_offset=k_off)
        bits = torch.equal(o.to_local().view(torch.int16),
                           mine.view(torch.int16))
        full = o.full_tensor()
        entry = {"bits": bits, "cp_ms": cp_ms}
        if rank == 0:
            ref = flash_attention(q, k, v, **kw)
            entry["full_ms"] = event_ms(
                lambda: flash_attention(q, k, v, **kw), 3)
            entry["max_abs"] = (full.float() - ref.float()).abs().max() \
                .item()
        out[kind] = entry
        check(bits, f"11c {kind}: rank {rank}'s slice != its own "
              f"flash_attention")
    res["c"] = out


def mesh_local_experts(dev, rank, world, res):
    """11d: llama4-scout's MoE block at full width (one layer's worth),
    ``moe_apply(mesh=)`` with shard-local expert choice on the (2, 2)
    mesh against one process's ``moe_apply(groups=2)`` on the same
    tokens, with the normed tokens and router logits as witnesses."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import base, moe
    from repro_torch.models.api import _Block
    cfg = get_config("llama4-scout-17b-a16e", moe_local_dispatch=True)
    mesh = make_host_mesh(2)
    block = _Block(moe.moe_template(cfg), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 504)
    with torch.no_grad():
        for name, spec in base.leaves(moe.moe_template(cfg)):
            node = block
            for key in name:
                node = getattr(node, key)
            base.initialize_(node, spec, gen)
    tokens = LLAMA4_MESH_TOKENS
    x = (torch.randn((*tokens, cfg.d_model), generator=gen, device=dev)
         * 0.5).to(torch.bfloat16)

    def tree(node, tpl, fn):
        """The block's parameters as a namespace, each through fn."""
        out = types.SimpleNamespace()
        for key, sub in tpl.items():
            v = getattr(node, key)
            setattr(out, key, fn(v.detach(), sub) if base.is_param(sub)
                    else tree(v, sub, fn))
        return out
    tpl = moe.moe_template(cfg)
    pm = tree(block, tpl, lambda v, sub: base.distribute(
        v, mesh, base.placements(base.resolve_logical(
            sub.logical, sub.shape, mesh), mesh)))
    xd = base.distribute(x, mesh, base.placements(base.P(("data",)), mesh))
    b, t = tokens
    tl, e = b * t // 2, cfg.n_experts
    cl = max(1, tl * cfg.top_k // e)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, zloss = moe.moe_apply(pm, xd, cfg, train=True, mesh=mesh)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        # the witnesses: the normed tokens, the router logits and each
        # data shard's picks (the mesh dispatch's own _route) on the mesh
        xn = base.rms_norm(xd, pm.norm, cfg.norm_eps)
        logits = moe.router_logits(xn, pm.router, mesh)
        picks = base.local_map(
            lambda xl, lg: moe._route(xl.reshape(1, tl, -1),
                                      lg.reshape(1, tl, e), cl)[2],
            mesh, (xn, logits), xn.placements)
        got, xn, logits, picks = (t.full_tensor()
                                  for t in (out, xn, logits, picks))
    if rank == 0:
        with torch.no_grad():
            want, w_zloss = moe.moe_apply(block, x, cfg, train=True,
                                          groups=2)
            w_xn = base.rms_norm(x, block.norm, cfg.norm_eps)
            w_logits = moe.router_logits(w_xn, block.router)
            w_picks = moe._route(w_xn.reshape(2, tl, -1),
                                 w_logits.reshape(2, tl, e), cl)[2]
            # float32 truth with the same routing (the bf16 path's
            # logits): the block's weights and normed tokens in float32
            f32 = tree(block, tpl, lambda v, sub: v.float())
            xn32 = base.rms_norm(x.float(), f32.norm, cfg.norm_eps)
            update = moe._expert_choice_local(f32, xn32, w_logits, cfg, 2,
                                              train=True) \
                + base.swiglu(xn32, f32.shared.w_gate, f32.shared.w_up,
                              f32.shared.w_down, True)
            truth = x.float() + update

        def err(v):            # relative L2 against the float32 update
            return ((v.float() - truth).norm() / update.norm()).item()

        def ulp(v):            # tests/test_torch_moe.py's one-ulp rule
            return 2.0 ** -7 * v.abs().clamp_min(2.0 ** -6)
        g, w = got.float(), want.float()
        d = (g - w).abs()
        res["d"] = {
            "xn_differ": int((xn.view(torch.int16)
                              != w_xn.view(torch.int16)).sum()),
            "logits_differ": int((logits != w_logits).sum()),
            "logits_max": (logits - w_logits).abs().max().item(),
            "picks_differ": int((picks != w_picks).sum()),
            "picks": picks.numel(),
            "out_differ": int((got.view(torch.int16)
                               != want.view(torch.int16)).sum()),
            "err_mesh": err(got), "err_one": err(want),
            "ulp_worst": (d / (ulp(w) + ulp(w - x.float()))).max().item(),
            "err_std": (d.max() / w.std()).item(),
            "zloss": [float(zloss), float(w_zloss)],
            "mesh_s": mesh_s, "elements": got.numel(),
            "bytes": sum(p.numel() * p.element_size()
                         for p in block.parameters())}


def mesh_launch_train(dev, rank, world, res):
    """11e: ``launch.train --model-parallel 2`` on the world (the
    launcher builds the (2, 2) mesh from the process group) into a
    checkpoint directory that rank 0 names."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as LT
    ckpt = [tempfile.mkdtemp(dir=ROOT / "build" / "chip_smoke")
            if rank == 0 else None]
    dist.broadcast_object_list(ckpt)
    try:
        out = LT.main(LAUNCH_MESH_ARGS + ["--model-parallel", "2",
                                          "--checkpoint-dir", ckpt[0]])
        everyone = [None] * world
        dist.all_gather_object(everyone, out.losses)
        dist.barrier()
        if rank == 0:
            res["e"] = {"losses": everyone, "seconds": out.step_seconds,
                        "final_step": out.final_step,
                        "skipped": out.skipped_steps,
                        "saved": CheckpointManager(ckpt[0]).latest_step()}
    finally:
        dist.barrier()
        if rank == 0:
            shutil.rmtree(ckpt[0], ignore_errors=True)


def phase_mesh(smi):
    """Phase 11: the mesh path in spawned worlds (the main process keeps
    no process group: phase 10's ``launch.train`` reads the world)."""
    import torch.multiprocessing as mp
    print(f"phase 11: the mesh path (DTensor) [{smi}]")
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    results = {"launch_meshless": launch_meshless()}
    for part, world in (("a", 1), ("bcde", MESH_WORLD)):
        store = work / f"mesh_store.{os.getpid()}.{part}"
        out = work / f"mesh_world.{os.getpid()}.{part}"
        for f in (store, out):
            f.unlink(missing_ok=True)
        t1 = time.perf_counter()
        ctx = mp.spawn(mesh_rank, args=(world, f"file://{store}", str(out),
                                        part), nprocs=world, join=False)
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t1 > MESH_LIMIT_S:
                    raise RuntimeError(f"phase 11{part}: the world passed "
                                       f"{MESH_LIMIT_S} s")
            results[part] = json.loads(out.read_text())
            results[part]["wall_s"] = time.perf_counter() - t1
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            for f in (store, out):
                f.unlink(missing_ok=True)
    report_mesh(results, smi)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")


def launch_meshless():
    """11e's reference: the same ``launch.train`` run in this process,
    no process group, no mesh: (losses, step seconds)."""
    from repro_torch.launch import train as LT
    ckpt = tempfile.mkdtemp(dir=ROOT / "build" / "chip_smoke")
    try:
        res = LT.main(LAUNCH_MESH_ARGS + ["--checkpoint-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    free()
    return res.losses, res.step_seconds


def report_mesh(results, smi):
    """Phase 11's gates and figures."""
    a, w = results["a"], results["bcde"]
    g = GEMMA3_MESH
    (m_loss, p_loss), (m_sec, p_sec) = a["a_losses"], a["a_seconds"]
    check(all(np.isfinite(m_loss)), f"11a: losses {m_loss}")
    # a (1, 1) mesh runs the mesh-less step's local ops: bit for bit
    check(not a["a_differ"],
          f"11a: {len(a['a_differ'])} leaves differ ({a['a_differ'][:5]}),"
          f" worst relative L2 {a['a_worst']}")
    check(m_loss == p_loss, f"11a: losses {m_loss} != mesh-less {p_loss}")
    print(f"  11a (1, 1) mesh, {a['backend']}: gemma3-1b full width and "
          f"depth ({a['a_params']:,} parameters), {g['steps_a']} steps of "
          f"{g['batch']} x {g['seq_a']}, remat: losses "
          f"{'bit-equal' if m_loss == p_loss else 'differ'} to the "
          f"mesh-less step ({', '.join(f'{v:.6f}' for v in m_loss)}); "
          f"{a['a_leaves'] - len(a['a_differ'])} of {a['a_leaves']} "
          f"parameter and moment leaves bit-equal"
          + (f" (differ: {a['a_differ'][:5]}, worst relative L2 "
             f"{a['a_worst']:.2e})" if a["a_differ"] else "")
          + f"; step {statistics.median(m_sec[1:]) * 1e3:.1f} ms vs "
          f"mesh-less {statistics.median(p_sec[1:]) * 1e3:.1f} ms "
          f"(median of steps 1-{g['steps_a'] - 1}); peak "
          f"{a['a_peak'][0]:.2f} GiB vs {a['a_peak'][1]:.2f} GiB; world "
          f"{a['wall_s']:.1f} s [{smi}]")
    print(f"  11b-d world: {MESH_WORLD} ranks, backend {w['backend']} "
          f"(CUDA tensors); collectives probed: {w['probe']}")
    gr = w["b_grad"]
    check(abs(gr["losses"]["f32"] - gr["losses"]["plain_f32"])
          <= TRAIN_LOSS_RTOL[torch.float32] * abs(gr["losses"]["plain_f32"])
          and abs(gr["losses"]["bf16"] - gr["losses"]["plain_bf16"])
          <= TRAIN_LOSS_RTOL[torch.bfloat16]
          * abs(gr["losses"]["plain_bf16"]), f"11b (ii) losses {gr}")
    check(gr["f32_worst"][1][0] <= TRAIN_F32_GRAD_RTOL,
          f"11b (ii) float32 gradient {gr['f32_worst']}")
    check(not gr["bf16_bad"], f"11b (ii) bf16 gradients {gr['bf16_bad']}")
    per_rank = w["b_losses"]
    check(w["b_placed"], "11b (i): placements differ from param_specs")
    check(all(x == per_rank[0] for x in per_rank),
          f"11b (iii): the ranks' losses differ {per_rank}")
    fall = g["falls"]
    first, last = (np.mean(per_rank[0][:fall]), np.mean(per_rank[0][-fall:]))
    check(last < first, f"11b (iv): {per_rank[0]}")
    check(len(w["b_own_syncs"]) == STEP_SYNCS,
          f"11b (v): {w['b_own_syncs']} ({len(w['b_syncs'])} in all)")
    print(f"  11b (2, 2) ('data', 'model'): gemma3-1b full width, "
          f"{g['layers_b']} layers ({w['b_params']:,} parameters), "
          f"{g['steps_b']} steps of {g['batch']} x {g['seq_b']}: (i) "
          f"{w['b_leaves']} leaves at param_specs' placements, moments "
          f"too ({w['b_sharded']} sharded, {w['b_leaves'] - w['b_sharded']}"
          f" replicated); (ii) step-1 loss mesh/mesh-less "
          f"{gr['losses']['f32']:.6f}/{gr['losses']['plain_f32']:.6f} "
          f"(float32), {gr['losses']['bf16']:.6f}/"
          f"{gr['losses']['plain_bf16']:.6f} (bf16); worst float32 "
          f"gradient leaf {gr['f32_worst'][0]} {gr['f32_worst'][1][0]:.2e}"
          f"; bf16 leaves within the rule ({gr['leaves']}), worst at "
          f"{gr['bf16_worst_ratio']:.2f} of its bound; (iii) the 4 ranks' "
          f"losses bit-equal ({', '.join(f'{v:.6f}' for v in per_rank[0])})"
          f"; (iv) falls {first:.4f} -> {last:.4f} (the mean of the "
          f"first and last {fall}); (v) {len(w['b_own_syncs'])} sync a "
          f"step of the step's own ({', '.join(w['b_own_syncs'])}), "
          f"{len(w['b_syncs'])} with the backend's; step "
          f"{statistics.median(w['b_seconds'][1:]) * 1e3:.1f} ms (median "
          f"of steps 1-{g['steps_b'] - 1}); collectives a step "
          f"{w['b_comm']}; peak {w['b_peak']:.2f} GiB a rank; gradient "
          f"checks {w['b_grad_s']:.1f} s [{smi}]")
    for kind, e in w["c"].items():
        check(e["max_abs"] < 0.05, f"11c {kind}: {e['max_abs']}")
        print(f"  11c context parallel (1, {MESH_WORLD}), {kind}"
              + (f" {CP_SHAPE['window']}" if kind == "local" else "")
              + f": B {CP_SHAPE['B']}, S {CP_SHAPE['S']}, H {CP_SHAPE['H']},"
              f" KV {CP_SHAPE['KV']}, hd {CP_SHAPE['D']}: every rank's "
              f"slice = its flash_attention bit for bit; whole vs full "
              f"max |d| {e['max_abs']:.4f} (< 0.05); {e['cp_ms']:.2f} ms "
              f"a rank vs {e['full_ms']:.2f} ms whole [{smi}]")
    d = w["d"]
    bf16_bound = max(TRAIN_BF16_GRAD_RTOL, 2 * d["err_one"])
    print(f"  11d llama4-scout MoE block, full width (reduced: n_layers "
          f"48->1; {d['bytes'] / 1e9:.2f} GB), moe_local_dispatch, "
          f"{LLAMA4_MESH_TOKENS[0]} x {LLAMA4_MESH_TOKENS[1]} tokens on "
          f"(2, 2): moe_apply(mesh=) against one process's "
          f"moe_apply(groups=2): normed tokens differ in "
          f"{d['xn_differ']}, router logits in {d['logits_differ']} "
          f"(max |d| {d['logits_max']:.3e}), the data shards' picks in "
          f"{d['picks_differ']} of {d['picks']}; x + moe(x) differs in "
          f"{d['out_differ']} of {d['elements']:,} elements (max |d| "
          f"{d['err_std']:.4f} of the std, {d['ulp_worst']:.2f} of the "
          f"CPU tests' one-ulp rule); against the float32 block with the "
          f"same routing the update is off by {d['err_mesh']:.3e} "
          f"(relative L2) on the mesh and {d['err_one']:.3e} in one "
          f"process (bound {bf16_bound:.3e}); z-loss "
          f"{d['zloss'][0]:.6f} / {d['zloss'][1]:.6f}; "
          f"{d['mesh_s'] * 1e3:.1f} ms first call [{smi}]")
    check(d["logits_differ"] == 0 and d["picks_differ"] == 0,
          f"11d: the routing differs from one process's: logits in "
          f"{d['logits_differ']}, picks in {d['picks_differ']}")
    check(d["err_mesh"] <= bf16_bound, f"11d: the mesh's update is off by "
          f"{d['err_mesh']} > {bf16_bound}")
    check(abs(d["zloss"][0] - d["zloss"][1])
          <= TRAIN_LOSS_RTOL[torch.float32] * abs(d["zloss"][1]),
          f"11d: z-loss {d['zloss']}")
    e = w["e"]
    want, want_s = results["launch_meshless"]
    per_rank = e["losses"]
    steps = int(LAUNCH_MESH_ARGS[LAUNCH_MESH_ARGS.index("--steps") + 1])
    check(e["final_step"] == steps and e["skipped"] == 0
          and e["saved"] == steps, f"11e: {e}")
    check(all(x == per_rank[0] for x in per_rank),
          f"11e: the ranks' losses differ {per_rank}")
    check(all(abs(x - y) <= TRAIN_LOSS_RTOL[torch.bfloat16] * abs(y)
              for x, y in zip(per_rank[0], want)),
          f"11e: {per_rank[0]} against mesh-less {want}")
    print(f"  11e launch.train {' '.join(LAUNCH_MESH_ARGS[:8])} "
          f"--model-parallel 2 on the world: (2, 2) mesh, the 4 ranks' "
          f"losses bit-equal ({', '.join(f'{v:.6f}' for v in per_rank[0])})"
          f", mesh-less launch.train ({', '.join(f'{v:.6f}' for v in want)})"
          f" within {TRAIN_LOSS_RTOL[torch.bfloat16]:g}; checkpoint of step "
          f"{e['saved']} written from the mesh; step "
          f"{statistics.median(e['seconds'][1:]) * 1e3:.1f} ms vs mesh-less "
          f"{statistics.median(want_s[1:]) * 1e3:.1f} ms (median of steps "
          f"1-{steps - 1}); world {w['wall_s']:.1f} s [{smi}]")

# -------------------------- phase 12: serving on a mesh, the dry run

#: 12a/12b: phase 8's traffic on gemma2-9b (4 slots, 32-token prompts,
#: 16 new tokens); 12c: one slot, its caches' sequence split over "data"
SERVE_MESH = {"slots": 4, "plen": 32, "max_new": 16}
SEQ_MESH = {"plen": 4096, "s_cap": 8192, "steps": 8}
#: 12b-c's gemma2-9b depth, reduced: n_layers 42 -> 4 (two local/global
#: pairs): over gloo each step all-gathers every rank's quarter of the
#: weights through host memory, ~10 s a step at full depth
MESH_SERVE_LAYERS = 4
SERVE_MESH_LIMIT_S = 540
CARD_RULE = 0.1                    # phase 8's card = CPU rule (past 1 ulp)
#: 12d: (arch, shape, mesh, layers traced: None for the config's).
#: Reduced: gemma3-1b's depth 26 -> 6 (one local/global group) and
#: dbrx-132b's 40 -> 2, so that their fake traces (~6-10 s a layer on the
#: card's host) fit the run beside 12a-c
DRYRUN_CELLS = [("gemma3-1b", "train_4k", "pod1", 6),
                ("qwen3-32b", "decode_32k", "pod1", None),
                ("zamba2-1.2b", "long_500k", "pod1", None),
                ("dbrx-132b", "train_4k", "pod2", 2)]
DRYRUN_GATE = 1                    # the cell traced again on "cpu"
DRYRUN_LIMIT_S = 720


def recording(model):
    """Wrap ``model``'s ``prefill`` and ``decode_step`` to keep each
    call's logits (whole, float32, on the host) in the returned list;
    ``del model.prefill, model.decode_step`` unwraps."""
    seen = []

    def wrap(fn):
        def call(*args, **kwargs):
            caches, logits = fn(*args, **kwargs)
            whole = logits.full_tensor() if hasattr(logits, "full_tensor") \
                else logits
            seen.append(whole.float().cpu())
            return caches, logits
        return call
    model.prefill = wrap(model.prefill)
    model.decode_step = wrap(model.decode_step)
    return seen


def serve_traffic(model, mesh, prompts, s_cap, max_new):
    """``launch.serve.serve`` over ``prompts`` on ``ServeEngine(mesh=)``:
    (every prefill's and step's logits, each request's tokens, each
    step's milliseconds, the engine)."""
    from repro_torch.launch import serve as S
    seen = recording(model)
    eng = S.ServeEngine(model, len(prompts), prompts[0].shape[0], s_cap,
                        mesh=mesh)
    times, step = [], eng.step

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    eng.step = timed
    S.serve(eng, prompts, max_new)
    del model.prefill, model.decode_step
    eng.step = step
    return seen, [eng.outputs[i] for i in range(len(prompts))], times, eng


def step_comm(eng):
    """Collectives of one engine step by type (``CommDebugMode``)."""
    from torch.distributed.tensor.debug import CommDebugMode
    comm = CommDebugMode()
    with comm:
        eng.step()
    return {str(k).split(".")[-1]: v
            for k, v in comm.get_comm_counts().items()}


def own_syncs(fn):
    """Synchronizing CUDA calls of ``fn`` outside ``torch.distributed``
    (gloo stages CUDA tensors through the host inside it)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        caught.clear()
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchronizing" in str(w.message)
            and f"{os.sep}distributed{os.sep}" not in w.filename]


def digest(t):
    """A tensor's bytes' SHA-256 (the same on every process)."""
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def serve_mesh_rank(rank, world, init, out_dir):
    """One rank of 12b-c's world: gemma2-9b at full width and depth on
    (2, 2), gloo on one card (NCCL with a card a rank where there are
    four)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import batch_spec, cache_specs
    from repro_torch.models.base import placements
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    backend = mesh_backend(world)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=SERVE_MESH_LIMIT_S))
    if backend == "gloo":
        route_gloo_all_gather()
    out = pathlib.Path(out_dir)
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        cfg = get_config("gemma2-9b", n_layers=MESH_SERVE_LAYERS)
        mesh = make_host_mesh(2)
        t0 = time.perf_counter()
        model = built(cfg, dev, SEED + 1200)[0].distribute_(mesh)
        free()
        torch.cuda.synchronize()
        res = {"backend": backend, "init_s": time.perf_counter() - t0,
               "params": model.param_count()}
        g, q = SERVE_MESH, SEQ_MESH
        prompts = cli_prompts(g["slots"], g["plen"], cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        seen, outs, times, eng = serve_traffic(
            model, mesh, prompts, g["plen"] + g["max_new"] + 8,
            g["max_new"])
        specs = cache_specs(model.cache_spec(eng.slots, eng.s_cap), mesh)
        vec = placements(batch_spec(mesh, 1, eng.slots), mesh)
        placed = all(buf.placements == placements(specs[i][n], mesh)
                     for i, layer in enumerate(eng.caches)
                     for n, buf in layer.items()) and \
            eng.cur.placements == vec and eng.pos.placements == vec
        res.update(b_peak=peak_gib(), b_times=times, b_placed=bool(placed),
                   b_comm=step_comm(eng), b_own_syncs=own_syncs(eng.step),
                   b_outs=outs)
        everyone = [None] * world
        dist.all_gather_object(everyone, [digest(t) for t in seen]
                               + [outs])
        res["b_ranks_equal"] = all(e == everyone[0] for e in everyone)
        if rank == 0:
            torch.save(seen, out / "b_mesh.pt")
            print(f"  [12b: {time.perf_counter() - t0:.1f} s]", flush=True)
        del eng, seen
        free()
        prompt = cli_prompts(1, q["plen"], cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        seen, outs, times, eng = serve_traffic(model, mesh, prompt,
                                               q["s_cap"], q["steps"])
        everyone = [None] * world
        dist.all_gather_object(everyone, [digest(t) for t in seen]
                               + [outs])
        res.update(c_peak=peak_gib(), c_times=times, c_outs=outs,
                   c_ranks_equal=all(e == everyone[0] for e in everyone),
                   c_layout=[str(p) for p in eng.caches[0]["k"].placements],
                   c_seq_split=all(buf.placements[0].is_shard(1)
                                   for layer in eng.caches
                                   for buf in layer.values()),
                   c_comm=step_comm(eng))
        if rank == 0:
            torch.save(seen, out / "c_mesh.pt")
            (out / "world.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def serve_mesh_plain(device, out):
    """12b-c's mesh-less runs in this process (gemma2-9b at their depth),
    their logits saved for the report."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma2-9b", n_layers=MESH_SERVE_LAYERS)
    g, q = SERVE_MESH, SEQ_MESH
    model, _ = built(cfg, device, SEED + 1200)
    plain, outs, times, _ = serve_traffic(
        model, None, cli_prompts(g["slots"], g["plen"], cfg.vocab_size),
        g["plen"] + g["max_new"] + 8, g["max_new"])
    torch.save(plain, out / "b_plain.pt")
    seq, c_outs, c_times, _ = serve_traffic(
        model, None, cli_prompts(1, q["plen"], cfg.vocab_size), q["s_cap"],
        q["steps"])
    torch.save(seq, out / "c_plain.pt")
    del model, plain, seq
    free()
    return {"b_plain_times": times, "b_plain_outs": outs,
            "c_plain_times": c_times, "c_plain_outs": c_outs}


def serve_mesh_one(device, out):
    """12a in this process: gemma2-9b at full width and depth mesh-less,
    then the same model on a (1, 1) mesh in a world of one rank
    (destroyed after)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config("gemma2-9b")
    g = SERVE_MESH
    prompts = cli_prompts(g["slots"], g["plen"], cfg.vocab_size)
    s_cap = g["plen"] + g["max_new"] + 8
    model, init_s = built(cfg, device, SEED + 1200)
    torch.cuda.reset_peak_memory_stats()
    plain, outs, times, _ = serve_traffic(model, None, prompts, s_cap,
                                          g["max_new"])
    res = {"init_s": init_s, "plain_peak": peak_gib(), "plain_times": times,
           "plain_outs": outs}
    store = out / f"one_store.{os.getpid()}"
    store.unlink(missing_ok=True)
    dist.init_process_group(mesh_backend(1), init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1)
        model.distribute_(mesh)
        free()
        torch.cuda.reset_peak_memory_stats()
        seen, one_outs, one_times, _ = serve_traffic(model, mesh, prompts,
                                                     s_cap, g["max_new"])
        res.update(one_peak=peak_gib(), one_times=one_times,
                   one_outs=one_outs, n_logits=len(seen),
                   one_differ=[i for i, (a, b) in enumerate(zip(seen, plain))
                               if not torch.equal(a, b)]
                   + ([-1] if len(seen) != len(plain) else []))
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    del model, seen, plain
    free()
    return res


def dryrun_cells(out_path):
    """12e and 12d in a process of its own: the profiler's launch counts
    (this process has traced nothing before: in one whose profiler
    traced phase 10's training steps, torch 2.11's next sessions may
    record no device events), then the dry run's cells (fake worlds of
    256 and 512 ranks, cuda meshes), the gate's cell again on "cpu", and
    ``python -m repro_torch.launch.dryrun --list``."""
    from repro_torch.launch import dryrun as D
    res = {"launches": kernel_launch_counts(torch.device("cuda", 0)),
           "cells": []}
    t0 = time.perf_counter()
    listed = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    res["list"] = [listed.returncode, len(listed.stdout.split("\n")) - 1,
                   time.perf_counter() - t0]
    for arch, shape, mesh, layers in DRYRUN_CELLS:
        res["cells"].append(D.run_cell(arch, shape, mesh, layers and {
            "n_layers": layers}))
    arch, shape, mesh, layers = DRYRUN_CELLS[DRYRUN_GATE]
    res["gate"] = D.run_cell(arch, shape, mesh, layers and {
        "n_layers": layers}, device_type="cpu")
    pathlib.Path(out_path).write_text(json.dumps(res))


def kernel_launch_counts(device):
    """12e: ``roofline.count_kernel_launches`` against the launch
    counters and ``bank.launch_count``."""
    from repro_torch import designs
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.roofline import count_kernel_launches
    rng = np.random.default_rng(SEED + 1300)
    out = {}

    def counted(label, fn, args, want):
        before = sum(launch_counts().values())
        got = count_kernel_launches(fn, *args)
        counters = sum(launch_counts().values()) - before
        check(got == counters == want, f"12e {label}: profiler {got}, "
              f"counters {counters}, bank {want}")
        out[label] = got
    fused = designs.generate("tp3p5_w32")
    a, b = operands(rng, (B_MAIN,), 32, device)
    counted("tp3p5_w32 fused round", fused.mul, (a, b),
            fused.bank.launch_count(B_MAIN))
    check(out["tp3p5_w32 fused round"] == 1, f"12e: {out}")
    spec = dataclasses.replace(designs.get("tbl8_w128_strict"),
                               backend="kernel")
    per = designs.generate(spec)
    a2, b2 = operands(rng, (B_MAIN,), spec.bits_a, device)
    counted("tbl8_w128_strict kernel round", per.mul, (a2, b2),
            per.bank.launch_count(B_MAIN))
    check(out["tbl8_w128_strict kernel round"]
          == len(per.bank.instances), f"12e: {out}")

    def two(x, y):
        fused.mul(x, y)
        fused.mul(y, x)
    counted("two fused rounds", two, (a, b),
            2 * fused.bank.launch_count(B_MAIN))
    return out


def phase_serve_mesh(smi):
    """Phase 12: serving on a mesh (12a-c), and alongside in a process
    of its own the profiler's launch count (12e) and the dry run
    (12d)."""
    import torch.multiprocessing as mp
    print(f"phase 12: serving on a mesh and the dry run [{smi}]")
    device = torch.device("cuda", 0)
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    dry_out = work / f"dryrun.{os.getpid()}.json"
    dry_out.unlink(missing_ok=True)
    dry = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "import chip_smoke as C; C.dryrun_cells(sys.argv[1])",
         str(dry_out)], cwd=ROOT)
    try:
        a = serve_mesh_one(device, work)
        a.update(serve_mesh_plain(device, work))
        print(f"  [12a and 12b-c's mesh-less runs: "
              f"{time.perf_counter() - t0:.1f} s]", flush=True)
        store = work / f"serve_store.{os.getpid()}"
        store.unlink(missing_ok=True)
        t1 = time.perf_counter()
        ctx = mp.spawn(serve_mesh_rank, args=(MESH_WORLD, f"file://{store}",
                                              str(work)),
                       nprocs=MESH_WORLD, join=False)
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t1 > SERVE_MESH_LIMIT_S:
                    raise RuntimeError(f"phase 12b-c: the world passed "
                                       f"{SERVE_MESH_LIMIT_S} s")
            w = json.loads((work / "world.json").read_text())
            w["wall_s"] = time.perf_counter() - t1
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            store.unlink(missing_ok=True)
        report_serve_mesh(a, w, work, smi)
        t2 = time.perf_counter()
        dry.wait(timeout=max(DRYRUN_LIMIT_S - (t2 - t0), 1))
        check(dry.returncode == 0, f"12d-e: their process exited "
              f"{dry.returncode}")
        d = json.loads(dry_out.read_text())
        print(f"  12e roofline.count_kernel_launches (torch.profiler's "
              f"device events of csrc/'s kernels) = the launch counters = "
              f"bank.launch_count: {d['launches']}")
        report_dryrun(d, time.perf_counter() - t0, smi)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        for f in ("b_plain.pt", "c_plain.pt", "b_mesh.pt", "c_mesh.pt",
                  "world.json", dry_out.name):
            (work / f).unlink(missing_ok=True)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")


def report_serve_mesh(a, w, work, smi):
    """12a-c's gates and figures."""
    g, q = SERVE_MESH, SEQ_MESH
    med = statistics.median
    check(not a["one_differ"], f"12a: logits {a['one_differ']} differ")
    check(a["one_outs"] == a["plain_outs"], "12a: tokens differ")
    print(f"  12a (1, 1) mesh, {mesh_backend(1)}: gemma2-9b full width and "
          f"depth, {g['slots']} x {g['plen']}-token prompts, "
          f"{g['max_new']} new tokens: all {a['n_logits']} prefill and "
          f"decode logits and every token bit-equal to the mesh-less "
          f"engine; step {med(a['one_times']):.1f} ms vs mesh-less "
          f"{med(a['plain_times']):.1f} ms (median of "
          f"{len(a['one_times'])}); peak {a['one_peak']:.2f} GiB vs "
          f"{a['plain_peak']:.2f} GiB [{smi}]")
    plain, mesh = torch.load(work / "b_plain.pt"), torch.load(
        work / "b_mesh.pt")
    first = [rel_err_past_ulp(m, p) for m, p in zip(mesh[:2], plain[:2])]
    every = [rel_err_past_ulp(m, p) for m, p in zip(mesh, plain)]
    same = sum(x == y for x, y in zip(w["b_outs"], a["b_plain_outs"]))
    print(f"  12b (2, 2) ('data', 'model'), {MESH_WORLD} ranks over "
          f"{w['backend']}: gemma2-9b at full width (reduced: n_layers 42 "
          f"-> {MESH_SERVE_LAYERS}; {w['params']:,} parameters, drawn and "
          f"distributed in {w['init_s']:.1f} s), the same traffic: the ranks' tokens "
          f"and logits {'bit-equal' if w['b_ranks_equal'] else 'DIFFER'}; "
          f"caches, cur and pos "
          f"{'at' if w['b_placed'] else 'NOT at'} cache_specs' and "
          f"batch_spec's placements; prefill and first step against the "
          f"mesh-less engine {', '.join(f'{e:.4f}' for e in first)} of the "
          f"std past one bf16 ulp (<= {CARD_RULE}; every step's worst "
          f"{max(every):.4f}); {same} of {g['slots']} requests' tokens "
          f"equal the mesh-less engine's; {len(w['b_own_syncs'])} sync a "
          f"step ({', '.join(w['b_own_syncs'])}); step "
          f"{med(w['b_times']):.1f} ms (median of {len(w['b_times'])}) vs "
          f"mesh-less {med(a['b_plain_times']):.1f} ms; collectives a step "
          f"{w['b_comm']}; peak {w['b_peak']:.2f} GiB a rank [{smi}]")
    check(w["b_ranks_equal"], "12b: the ranks' tokens or logits differ")
    check(max(first) <= CARD_RULE, f"12b: first logits {first}")
    check(w["b_placed"], "12b: caches, cur or pos off their specs")
    check(len(w["b_own_syncs"]) == STEP_SYNCS,
          f"12b: {w['b_own_syncs']} syncs a step")
    plain, mesh = torch.load(work / "c_plain.pt"), torch.load(
        work / "c_mesh.pt")
    errs = [rel_err_past_ulp(m, p) for m, p in zip(mesh, plain)]
    print(f"  12c one slot on (2, 2): a {q['plen']}-token prompt, s_cap "
          f"{q['s_cap']}, {q['steps']} steps: the first layer's k at "
          f"{w['c_layout']} (the sequence over 'data'), every logit "
          f"within {max(errs):.4f} of the std past one ulp of the "
          f"mesh-less engine (<= {CARD_RULE}); tokens "
          f"{'equal' if w['c_outs'] == a['c_plain_outs'] else 'differ'}; "
          f"step {med(w['c_times']):.1f} ms vs mesh-less "
          f"{med(a['c_plain_times']):.1f} ms; the merge's collectives a "
          f"step {w['c_comm']}; peak {w['c_peak']:.2f} GiB a rank; world "
          f"{w['wall_s']:.1f} s [{smi}]")
    check(len(mesh) == len(plain) and max(errs) <= CARD_RULE,
          f"12c: {errs}")
    check(w["c_ranks_equal"], "12c: the ranks' tokens or logits differ")
    check(w["c_seq_split"], f"12c: the caches' sequence is not split "
          f"over 'data': {w['c_layout']}")


def report_dryrun(d, elapsed, smi):
    """12d's lines and its gate."""
    from repro_torch.launch.dryrun import summary
    rc, n, list_s = d["list"]
    check(rc == 0 and n > 0, f"12d: --list gave {rc}, {n} cells")
    print(f"  12d python -m repro_torch.launch.dryrun --list: {n} cells "
          f"({list_s:.1f} s)")
    for (arch, shape, mesh, layers), res in zip(DRYRUN_CELLS, d["cells"]):
        cut = f" (reduced: n_layers -> {layers})" if layers else ""
        print(f"  12d {summary(res)}{cut}; model flops a rank "
              f"{res['model_flops_per_device']:.4e} [{smi}]")
    gate, cell = d["gate"], d["cells"][DRYRUN_GATE]
    keys = ("flops_per_device", "bytes_per_device", "collectives",
            "link_bytes_per_device")
    differ = [k for k in keys if gate[k] != cell[k]]
    check(not differ, f"12d: the cpu trace differs in {differ}")
    print(f"  12d gate: {cell['arch']} {cell['shape']} traced again with "
          f"device_type='cpu' gives the same flops, bytes and collectives;"
          f" 12d-e done {elapsed:.1f} s after phase 12 began, alongside "
          f"12a-c")


# ----------------------------------------------------------------- phase 13

#: phase 13e: the fused rounds at B = 1,048,576 before the launches
#: became custom ops (mul round ms, CUDA events; PERF.md section 5)
BEFORE_OPS_ROUND_MS = {"tp3p5_w32": 508.8, "tp5over6_w128": 822.0}
GATE_LIMIT_S = 300


def gate_cli(smi):
    """13a: ``python -m repro_torch.verify --smoke --device cuda`` in a
    subprocess; exit 0, its ``kernels`` section clean."""
    out = ROOT / "build" / "chip_smoke" / "VERIFY_torch_report.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.verify", "--smoke", "--device",
         "cuda", "--out", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=GATE_LIMIT_S)
    elapsed = time.perf_counter() - t0
    print("\n".join(f"    {line}" for line in proc.stdout.splitlines()))
    check(proc.returncode == 0, f"13a: verify exited {proc.returncode}:\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(out.read_text())
    kernels = report["kernels"]
    check(kernels and all(k["ok"] for k in kernels)
          and report["summary"]["ok"], "13a: a contract fails on the card")
    for k in kernels:
        check(k["card"] == k["declared"] and k["local_bytes"] == 0,
              f"13a: {k}")
    regs = {}
    for k in kernels:
        regs.setdefault((k["kernel"], k["path"]), set()).add(k["registers"])
    print(f"  13a verify --device cuda: exit 0 in {elapsed:.1f} s, "
          f"{len(kernels)} launch contracts = their *_launch_shape on "
          f"{smi}, 0 spill bytes; registers by launcher: " + ", ".join(
              f"{name} {path} {sorted(r)}"
              for (name, path), r in sorted(regs.items())))
    return report


def gate_bank_fake(device):
    """13b: ``check_bank_static`` on fake CUDA tensors, every registry
    design, the kernel and fused backends: no launch."""
    from repro_torch import designs
    from repro_torch.kernels import launch_counts
    from repro_torch.verify import contracts
    before = sum(launch_counts().values())
    t0 = time.perf_counter()
    checked = 0
    for name in designs.names():
        d = designs.generate(name)
        for backend in ("kernel", "fused"):
            if backend == "kernel" and d.spec.signed:
                continue          # the kernel capability is unsigned-only
            vs = contracts.check_bank_static(
                d.plan, d.spec.bits_a, d.spec.bits_b, backend=backend,
                batch=B_MAIN, device=device)
            check(not vs, f"13b {name} {backend}: "
                  f"{[v.describe() for v in vs]}")
            checked += 1
    check(sum(launch_counts().values()) == before,
          "13b: the fake-tensor dispatch launched a kernel")
    print(f"  13b check_bank_static on fake {device} tensors: {checked} "
          f"dispatches (13 designs x kernel, fused) at B={B_MAIN} clean, "
          f"0 launches, {time.perf_counter() - t0:.2f} s")


def gate_generate_ms():
    """13c: ``generate(name)`` on the card, cold (every cache of the
    gate cleared) and cached, ms a design; the dataflow gate alone."""
    from repro_torch import designs, verify
    from repro_torch.verify import dataflow

    def cold():
        verify.verify_instance.cache_clear()
        dataflow.clear_caches()
    rows = []
    for name in designs.names():
        cold()
        t0 = time.perf_counter()
        d = designs.generate(name)
        cold_ms = (time.perf_counter() - t0) * 1e3
        dataflow.clear_caches()
        t0 = time.perf_counter()
        verify.assert_plan_dataflow(d.spec.bits_a, d.spec.bits_b,
                                    d.plan.configs)
        gate_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        designs.generate(name)
        cached_ms = (time.perf_counter() - t0) * 1e3
        rows.append((name, cold_ms, gate_ms, cached_ms))
    for name, cold_ms, gate_ms, cached_ms in rows:
        print(f"    {name}: generate cold {cold_ms:.2f} ms (dataflow gate "
              f"{gate_ms:.2f} ms), cached {cached_ms:.2f} ms")
    print("  13c generate on the card, ms a design: cold median "
          f"{statistics.median(r[1] for r in rows):.2f}, dataflow gate "
          f"median {statistics.median(r[2] for r in rows):.2f} (max "
          f"{max(r[2] for r in rows):.2f}), cached median "
          f"{statistics.median(r[3] for r in rows):.2f}")


def gate_refuses_bad_table():
    """13d: one bad window in ``super_geometry``'s table (instance 0's
    first window one limb past LB, the windows and the table it is built
    from agreeing, so ``assert_plan``'s consistency checks pass):
    ``generate`` raises ``DataflowError`` and no kernel launches."""
    from repro_torch import designs, verify
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.bank_fold import geometry
    from repro_torch.verify import dataflow
    real = geometry.SuperGeometry.windows

    def bad(self, i):
        wins = real(self, i)
        return ((wins[0][0], self.lb + 1),) + wins[1:] if i == 0 else wins
    reset_launch_counts()
    geometry.SuperGeometry.windows = bad
    dataflow.clear_caches()
    try:
        designs.generate("tp3p5_w32")
        raised = None
    except verify.DataflowError as e:
        raised = e
    finally:
        geometry.SuperGeometry.windows = real
        dataflow.clear_caches()
    check(raised is not None, "13d: generate accepted a bad window")
    rules = sorted({v.rule for v in raised.violations})
    check("window-bounds" in rules, f"13d: rules {rules}")
    launched = sum(launch_counts().values())
    check(launched == 0, f"13d: {launched} launches")
    print(f"  13d bad window: generate raised DataflowError ({rules}), "
          f"{launched} launches")


def gate_round_host(device, rounds):
    """13e: phase 4's round at B = 1,048,576 on the custom ops: the mul
    round, its host report and dispatch enqueue, and the custom op's own
    host cost a call against the raw launch it wraps."""
    from repro_torch import designs
    from repro_torch.kernels import _build, _row_tiles
    from repro_torch.kernels import bank_fold as BF
    rng = np.random.default_rng(SEED + 13)
    for name in rounds:
        d = designs.generate(name)
        a, b = operands(rng, (B_TIME,), d.spec.bits_a, device)
        round_ms = cuda_ms(lambda: d.mul(a, b), iters=5)
        t0 = time.perf_counter()
        d.bank.report(B_TIME)
        report_ms = (time.perf_counter() - t0) * 1e3
        run = d.bank.dispatch_fn(B_TIME)
        enqueue = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(a, b)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        print(f"  13e round {name} B={B_TIME}: mul round {round_ms:.4f} ms"
              f" (before custom ops: {BEFORE_OPS_ROUND_MS[name]} ms), "
              f"host report "
              f"{report_ms:.4f} ms, dispatch enqueue (host) "
              f"{statistics.median(enqueue):.4f} ms")
    # the op against the raw launch, one small fused round (2 x 256 rows)
    a, b = operands(rng, (2, 256), 32, device)
    table = torch.tensor([[[0, 2]], [[0, 2]]], dtype=torch.int32,
                         device=device)
    out = torch.empty((2, 256, 4), dtype=torch.int32, device=device)
    path = BF.launch_plan(2, 256, 2, 2, _row_tiles.is_aligned(a, b))
    fn = _build.launcher("bank_fold", "bank_fold_bulk_launch"
                         if path == "bulk" else "bank_fold_launch", 4, 5)

    def host_us(call, n=300):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        per = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return per
    op_us = host_us(lambda: BF.fused_bank_mul(a, b, table))
    raw_us = host_us(lambda: _build.launch(
        "bank_fold", fn, (a, b, table, out), (2, 256, 2, 2, 1), path=path))
    print(f"  13e host a call: fused_bank_mul through the custom op "
          f"{op_us:.1f} us, the raw launch {raw_us:.1f} us "
          f"(op dispatch, checks and output allocation "
          f"{op_us - raw_us:.1f} us)")


def phase_gate(device, smi, rounds):
    """Phase 13: the plan-time gate on the card."""
    t0 = time.perf_counter()
    print(f"phase 13: the gate on the card [{smi}]")
    gate_cli(smi)
    gate_bank_fake(device)
    gate_generate_ms()
    gate_refuses_bad_table()
    gate_round_host(device, rounds)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    smi = phase_card()
    entries, rounds = phase_kernels(device)
    fused_counts, kernel_counts = phase_main_path(device)
    phase_rounds(device, rounds)
    entry_counts = phase_entry_points(device)
    phase_serving(device)
    phase_replicas(device)
    phase_collectives()
    phase_determinism(device)
    phase_models(device, smi)
    phase_families(device, smi)
    phase_training(device, smi)
    phase_mesh(smi)
    phase_serve_mesh(smi)
    phase_gate(device, smi, rounds)
    for e in entries:
        counter = e.pop("counter")
        counts = (fused_counts if counter == "bank_fold" else entry_counts
                  if counter in SLICE2_KERNELS else kernel_counts)
        e["launches"] = counts[counter]
        check(e["launches"] > 0, f"{e['name']}: never launched on the path")
    print(f"total {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
