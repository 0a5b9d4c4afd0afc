"""Build the hand-written CUDA kernels at first use and load them.

Each source in ``src/repro_torch/csrc`` is compiled by ``nvcc`` for
sm_90a into a shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/repro_torch/`` at the root of
the checkout, under a name that carries a hash of the source and flags,
so an edited source builds anew and concurrent processes never load a
half-written file (each compiles to a temporary name, then renames).
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# argument types of the launchers' C signatures
P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per source: nvcc's output (the ptxas register/shared-memory report)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns name -> library path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


# operands the kernels read as fp32; every other operand is int32
FLOAT_OPERANDS = frozenset({"vals", "b", "mask", "q", "k", "v", "x", "y"})


def check_operands(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Device, dtype and contiguity of every operand a kernel reads."""
    for arg, t in tensors.items():
        want = torch.float32 if arg in FLOAT_OPERANDS else torch.int32
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the operands on {device}")
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def raise_on(rc: int, name: str) -> None:
    """Raise on a launcher's nonzero cudaError (a refused launch)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def stream_of(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream


def load(name: str, signatures: Optional[Dict[str, Sequence]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed. Its
    first load declares every launcher in ``signatures`` (C name ->
    argument types; each returns its cudaError as an int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in (signatures or {}).items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = I
            _libs[name] = lib
        return lib

