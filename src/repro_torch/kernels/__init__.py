"""Hand-written Hopper kernels of the port, their build and launch counters.

Each kernel package ships
  ops.py  — the public wrapper.  On a CPU tensor it runs the plain PyTorch
            version; on a CUDA tensor it launches the CUDA kernel or raises.
            There is no switch and no fallback from a failed build or launch.
  ref.py  — the plain PyTorch version: the CPU path, and what the chip smoke
            run holds each kernel against on the card.

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/``.  Each ``.cu`` is built
at first use into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds) and loaded with ``ctypes``.  The
library's file name carries a hash of its source, the shared headers and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Importing compiles nothing: a source is built when one of its kernels is
first launched, or when :func:`build` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "launches", "reset_launches", "count_launch", "build",
           "load", "check", "stream_of", "ptr", "dtype_code", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <checkout>/build/repro_torch_kernels: the `build/` line of .gitignore
# already keeps it out of git
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("segsum", "hash_group", "hash_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# one launch counter per kernel; its wrapper adds one where it launches it
KERNELS = ("segsum_sum", "segsum_minmax", "hash_insert", "hash_probe64")
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)

_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}
_libs: dict[str, ctypes.CDLL] = {}
# ptxas -v report (registers, shared memory, spills) of each source built by
# this process; empty for a library found already built
build_log: dict[str, str] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count_launch(name: str) -> None:
    launches[name] += 1


def dtype_code(dt: torch.dtype) -> int:
    """The dtype code the C entry points take (csrc/common.cuh ``DType``)."""
    try:
        return _DTYPE_CODE[dt]
    except KeyError:
        raise TypeError(f"kernel does not take dtype {dt}") from None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named sources that are not built yet, all in parallel (one
    ``nvcc`` each).  Returns the wall seconds per source (0.0 when it was
    already built).  Raises with the compiler's output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, seconds = {}, {}
    for name in names:
        seconds[name] = 0.0
        if not _target(name).exists():
            todo[name] = _target(name)
    if not todo:
        return seconds
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed), with
    ``argtypes`` set from ``signatures`` and every function returning the
    CUDA error code as an int."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a contiguous tensor (None for an absent operand)."""
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    return t.data_ptr()
