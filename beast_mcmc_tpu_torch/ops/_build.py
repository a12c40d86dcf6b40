"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/lib<name>-<hash>.so` at the root of the
checkout, where <hash> covers the source and the shared headers, so an edited
kernel is rebuilt and a built one is reused. Sources are compiled at first
use, never at import; `build_all` starts one nvcc per source, all at once.

The libraries have a plain C interface: every pointer and the stream are
passed as `ctypes.c_void_p`, every size as `ctypes.c_int`, and each entry
point returns the `cudaError_t` of its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """Compile every named source not yet built, one nvcc each, in parallel.
    Returns {name: wall seconds} for those compiled now."""
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed, seconds = [], {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


class KernelCall:
    """One prepared launch: a C entry point taking (its pointers, its ints,
    stream), the tensors its pointers point into (held alive here) and the
    output (a tensor, or a tuple of them). `launch` enqueues it on the
    current stream of the tensors' device and raises on a non-zero
    cudaError_t."""

    def __init__(self, name: str, fn, tensors, ints, out):
        self.name, self.fn, self.tensors, self.ints, self.out = (
            name, fn, tuple(tensors), tuple(ints), out)
        self.device = self.tensors[0].device

    def launch(self):
        import torch

        with torch.cuda.device(self.device):
            err = self.fn(*[t.data_ptr() for t in self.tensors], *self.ints,
                          torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        return self.out


def load(name: str, entry_points: Sequence[str], n_ints: int,
         n_ptrs: int = 7) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>; declare each entry point as
    int f(n_ptrs pointers, n_ints ints, stream)."""
    if name not in _libs:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for ep in entry_points:
            fn = getattr(lib, ep)
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
