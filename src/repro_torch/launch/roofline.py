"""Roofline terms from a dry-run cell's counts, as the JAX package's
``launch/roofline.py``, with the NVIDIA H100's constants.

Hardware model (NVIDIA H100 SXM5 datasheet; dense rates at the full
700 W power limit):
  peak bf16 compute : 989e12 FLOP/s per card
  HBM3 bandwidth    : 3.35e12 B/s per card
  NVLink            : 450e9 B/s each way per card, within a node of 8
  network           : 50e9 B/s per card across nodes (400 Gb/s)

Terms (seconds, per step, per rank -- the counts of
:mod:`repro_torch.launch.op_cost` are one rank's):

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = each collective's link bytes over its group's link

Ring costs per op type (:func:`collective_link_bytes`): an all-reduce of
R result bytes moves 2R(k-1)/k per rank; an all-gather R(k-1)/k;
reduce-scatter R(k-1)/k of its operand (= result * k); all-to-all
R(k-1)/k; collective-permute R.  A group whose ranks all lie in one node
of :data:`NODE_GPUS` (ranks numbered node-major) runs at NVLink's rate,
any other at the network's: the reference's one ICI constant, split by
where the ranks sit.

:func:`count_kernel_launches` counts the CUDA launches of this package's
own kernels (``csrc/``) under ``torch.profiler``, the counterpart of the
reference's ``count_pallas_launches``.
"""
from __future__ import annotations

import functools
import pathlib
import re

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NET_BW = 50e9
NODE_GPUS = 8

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def link_bw(ranks) -> float:
    """The link rate of a group of global ``ranks``: NVLink within one
    node, else the network."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) <= 1 \
        else NET_BW


def ring_link_bytes(op: str, result_bytes: float, k: int) -> float:
    """Bytes one rank sends in a ring ``op`` of ``k`` ranks with
    ``result_bytes`` result bytes."""
    frac = (k - 1) / max(k, 1)
    if op == "all-reduce":
        return 2.0 * result_bytes * frac
    if op == "reduce-scatter":
        return result_bytes * k * frac
    if op in ("all-gather", "all-to-all"):
        return result_bytes * frac
    return float(result_bytes)                    # collective-permute


def collective_link_bytes(records) -> dict:
    """Per-type ``{count, result_bytes, link_bytes, seconds}`` of
    recorded collectives (``{"op", "result_bytes", "group_size",
    "ranks"}`` each, :mod:`.op_cost`'s), by ``parse_collectives``' rule:
    a group of one rank moves nothing and is not counted (but a
    collective-permute); ``seconds`` is the link bytes over the group's
    :func:`link_bw`."""
    out = {c: {"count": 0, "result_bytes": 0, "link_bytes": 0.0,
               "seconds": 0.0} for c in COLLECTIVES}
    for r in records:
        op, k = r["op"], r["group_size"]
        if k <= 1 and op != "collective-permute":
            continue
        link = ring_link_bytes(op, r["result_bytes"], k)
        out[op]["count"] += 1
        out[op]["result_bytes"] += r["result_bytes"]
        out[op]["link_bytes"] += link
        out[op]["seconds"] += link / link_bw(r.get("ranks") or range(k))
    return out


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   link_bytes_per_device: float,
                   collective_s: float | None = None) -> dict:
    """The reference's terms; ``collective_s`` (the sum of
    :func:`collective_link_bytes`' seconds) replaces link bytes over
    NVLink's rate where the groups' links are known."""
    compute = flops_per_device / PEAK_FLOPS
    memory = bytes_per_device / HBM_BW
    collective = link_bytes_per_device / NVLINK_BW \
        if collective_s is None else collective_s
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    bound = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        # fraction of the bound that is pure compute == roofline fraction
        # achievable if the dominant term were fully overlapped
        "compute_fraction": compute / bound if bound > 0 else 0.0,
    }


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """6ND for training, 2ND for forward-only (per the assignment)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


# ------------------------------------------------------------ launch counting

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"


@functools.lru_cache(maxsize=1)
def kernel_names() -> tuple:
    """The ``__global__`` functions of ``csrc/``: this package's own
    kernels."""
    names = set()
    for src in sorted(CSRC.glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    return tuple(sorted(names))


def count_kernel_launches(fn, *args) -> int:
    """CUDA launches of this package's own kernels that one call of
    ``fn(*args)`` issues, from ``torch.profiler``'s device events (the
    dispatch-tax metric of the fused bank: one launch a round for the
    fused kernel, one a busy instance for the per-instance kernels).
    The plain versions on the CPU launch none: 0.

    Raises ``RuntimeError`` where the count differs from the launches
    the kernels' wrappers counted meanwhile (``kernels.launch_counts``;
    each wrapper launches one kernel): in a process that traced a long
    run before, such as a profiled training step, torch 2.11's next
    profiler sessions may record no device events, and a count of 0
    would then pass for "no kernel launched".  Count in a fresh process.
    ``fn`` must not replay CUDA graphs, whose launches no wrapper
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ..kernels import launch_counts
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    before = sum(launch_counts().values())
    with profile(activities=acts) as prof:
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    launched = sum(launch_counts().values()) - before
    device = [e for e in prof.events() if e.device_type.name == "CUDA"]
    own = re.compile(r"\b(" + "|".join(kernel_names()) + r")\b")
    seen = sum(1 for e in device if own.search(e.name))
    if seen != launched:
        raise RuntimeError(
            f"torch.profiler saw {seen} launches of csrc/'s kernels "
            f"({len(device)} device events in all) where the wrappers "
            f"launched {launched}: the profiler is blind in this process "
            f"or fn replays a CUDA graph")
    return seen
