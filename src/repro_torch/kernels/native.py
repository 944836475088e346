"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build
runs at first use, every source in its own ``nvcc`` process and all of
them at once, into ``build/repro_torch/`` at the checkout's root (listed
in ``.gitignore``).  A library's file name carries a digest of its source,
the shared header and the flags, so an edited source rebuilds and an
unchanged one is reused.

One module lock serialises builds and loads, so threads that launch a
kernel for the first time at once (a service's background flusher and its
caller) build each library once; ``library_loads()`` counts the libraries
loaded so far, which lets a caller tell a wall time that included a build
or load from a warm one.

Flags: ``-fmad=false`` and no ``--use_fast_math`` keep every float
operation one IEEE-rounded operation in source order (correctly rounded
``sqrtf`` and division), which is what makes each kernel equal, bit for
bit, to its plain PyTorch version.

:class:`Kernel` is one C entry point plus its launch counter: the counter
moves by one where the entry point launched without error, and nowhere
else; ``last_block`` keeps the launch shape the wrapper gave that launch.
Nothing here is imported or built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "Kernel", "KERNELS",
           "build_all", "library_loads", "launches", "reset_launches",
           "check_cuda"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("integral_image.cu", "fused_head.cu", "haar_stage.cu",
           "packed_window.cu", "window_variance.cu", "tail_gates.cu")

_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.RLock()     # builds and loads, process-wide


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    found = cand if os.path.isfile(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the port's kernels")
    return found


def _library_path(source: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / source, CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{"seconds": wall time, "built": [...], "ptxas": {source:
    compiler report}}``; raises with the compiler's output if one fails.
    """
    with _build_lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src in SOURCES:
            target = _library_path(src)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
            procs[src] = (target, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports, failed = {}, []
        for src, (target, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            reports[src] = out
            target.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{src} (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return {"seconds": time.perf_counter() - t0, "built": list(procs),
                "ptxas": reports}


def _library(source: str) -> ctypes.CDLL:
    with _build_lock:
        if source not in _libs:
            path = _library_path(source)
            if not path.exists():
                build_all()
            _libs[source] = ctypes.CDLL(str(path))
        return _libs[source]


def library_loads() -> int:
    """Kernel libraries loaded in this process so far (each load follows
    its build when the library was missing)."""
    return len(_libs)


class Kernel:
    """One C entry point of a kernel library, with its launch counter."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.last_block = None
        self._fn = None
        KERNELS[Path(source).stem] = self

    def __call__(self, *args, block=None) -> None:
        if self._fn is None:
            lib = _library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = _library(self.source).repro_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1
        self.last_block = block


KERNELS: dict[str, Kernel] = {}


def launches() -> dict[str, int]:
    """Launch count of every kernel since the last :func:`reset_launches`."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def check_cuda(t: torch.Tensor, dtype: torch.dtype, ndim: int,
               name: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``ndim``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """The current PyTorch stream of ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
U64 = ctypes.c_ulonglong


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


CASCADE_ARGTYPES = [P] * 6


def cascade_ptrs(cascade, like: torch.Tensor) -> list:
    """Device pointers of the cascade's weak-classifier arrays and stage
    offsets (the kernels' common parameter block); the cascade must live
    on ``like``'s device."""
    fields = (cascade.rect_xywh, cascade.rect_w, cascade.wc_threshold,
              cascade.left_val, cascade.right_val, cascade.stage_offsets)
    for f in fields:
        if f.device != like.device or not f.is_contiguous():
            raise ValueError(f"cascade must be contiguous on {like.device}, "
                             f"got {f.device}")
    return [ptr(f) for f in fields]
