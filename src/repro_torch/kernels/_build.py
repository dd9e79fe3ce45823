"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``repro_torch/csrc/*.cu`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``
(pointers and the stream pass as ``c_void_p``).  Libraries go to
``build/repro_torch/`` at the root of the checkout, named by a hash of
the sources and flags, so an unchanged tree reuses them and an edited
one rebuilds.  All sources are compiled in parallel, once per process,
the first time any kernel is launched.

Every wrapper launches through :func:`launch`, which counts the launch
there and nowhere else, in :mod:`repro_torch.telemetry`'s counters
``launch.<kernel>``, for a kernel with two paths
``launch.<kernel>.<path>``, and for a launch of rows wider than
:data:`WIDE_LIMBS` also ``launch.<kernel>.wide``, whichever path it
takes; :func:`launch_counts`, :func:`path_counts` and
:func:`wide_counts` read them.  Nothing here sends a CUDA tensor to a
plain path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch import telemetry

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: one shared library per source file
SOURCES = ("bank_fold", "mcim_fold", "prefix_adder", "karatsuba_ppm",
           "int8_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: widest operand (limbs) the kernels take: 384-bit operands, which hold
#: BLS12-381's 381-bit field elements (``limbs::kMaxLimbs`` of
#: ``csrc/limbs.cuh``; the launchers refuse wider rows)
MAX_LIMBS = 24
#: rows wider than this (limbs) take the 24-limb instantiations, whose
#: launches are also counted as ``launch.<kernel>.wide``
WIDE_LIMBS = 16

_LIBS: dict = {}
_FNS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build() -> dict:
    """Compile every stale source in parallel; return {name: .so path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    stale = {n: p for n, p in paths.items() if not p.exists()}
    nvcc = _nvcc() if stale else None
    procs, failed = {}, []
    try:
        for name, path in stale.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            with open(path.with_suffix(".log"), "w") as log:
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
    finally:
        for name, (proc, tmp) in procs.items():   # all compile at once
            if proc.wait():
                failed.append(name)
            else:
                os.replace(tmp, paths[name])
    if failed:
        logs = "\n".join(paths[n].with_suffix(".log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, spills) for a source."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name`` (built on first use)."""
    if name not in _LIBS:
        paths = build()
        for n, path in paths.items():
            if n not in _LIBS:
                _LIBS[n] = ctypes.CDLL(str(path))
    return _LIBS[name]


def launcher(lib: str, symbol: str, n_ptrs: int, n_ints: int):
    """ctypes function ``int symbol(void* x n_ptrs, int x n_ints, void*
    stream)`` returning the launch's ``cudaGetLastError()``."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(library(lib), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def query(lib: str, symbol: str, ints) -> tuple:
    """Call a query entry ``int symbol(int x len(ints), int* info)`` of a
    source's library: a launcher's ``*_launch_shape`` (grid.x, grid.y,
    threads, dynamic shared bytes of the launch it makes for these
    arguments) or ``*_attributes`` (registers, local bytes, static
    shared bytes, most threads a block of the kernel it launches).
    Raises where the entry returns a CUDA error."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(library(lib), symbol)
        fn.argtypes = ([ctypes.c_int] * len(ints)
                       + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    info = (ctypes.c_int * 4)()
    err = fn(*ints, info)
    if err:
        raise RuntimeError(f"{symbol}{tuple(ints)}: CUDA error {err}")
    return tuple(info)


def launch(kernel: str, fn, tensors, ints, path: str | None = None,
           limbs: int = 0) -> None:
    """Launch ``fn`` on the current stream of the tensors' device, count
    it (and its ``path``, for a kernel with two; and, where its rows'
    ``limbs`` exceed :data:`WIDE_LIMBS`, as a wide launch), and raise if
    CUDA refused the launch."""
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *ints, stream)
    telemetry.count(f"launch.{kernel}")
    if path is not None:
        telemetry.count(f"launch.{kernel}.{path}")
    if limbs > WIDE_LIMBS:
        telemetry.count(f"launch.{kernel}.wide")
    if err:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def check_cuda_operands(name: str, *tensors,
                        dtype: torch.dtype = torch.int32) -> None:
    """Raise on operands the kernels do not take: not on CUDA, not of
    ``dtype`` (int32 limbs unless a kernel says otherwise), or not
    contiguous."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: operand on {t.device}, not CUDA")
        if t.dtype != dtype:
            raise ValueError(f"{name}: operands must be {dtype}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_limbs(name: str, la: int, lb: int) -> None:
    """Raise on limb counts above :data:`MAX_LIMBS`."""
    if max(la, lb) > MAX_LIMBS:
        raise ValueError(f"{name}: {la}x{lb} limbs exceed the kernels' "
                         f"{MAX_LIMBS}-limb ({16 * MAX_LIMBS}-bit) operand "
                         f"limit")


def reset_launch_counts() -> None:
    """Zero the launch counters, with the rest of the recorder's process
    totals (:func:`repro_torch.telemetry.reset`)."""
    telemetry.reset()


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    counters = telemetry.totals()["counters"]
    return {k: counters[f"launch.{k}"] for k in telemetry.KERNELS}


def path_counts() -> dict:
    """Launches of the row-tile kernels by path since the last reset."""
    counters = telemetry.totals()["counters"]
    return {k: {p: counters[f"launch.{k}.{p}"] for p in paths}
            for k, paths in telemetry.KERNEL_PATHS.items()}


def wide_counts() -> dict:
    """Launches of each limb kernel on rows wider than
    :data:`WIDE_LIMBS` since the last reset."""
    counters = telemetry.totals()["counters"]
    return {k: counters[f"launch.{k}.wide"] for k in telemetry.WIDE_KERNELS}
