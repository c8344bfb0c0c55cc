"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
one ``librepro_torch_kernels.so`` with a plain C interface.  The build
lands in ``build/repro_torch_kernels/<key>/`` at the root of the checkout,
keyed on a hash of the sources and flags, so the first call in a fresh
checkout builds everything and later calls (and processes) reuse it.

Nothing here runs at import time: the library is built and loaded on the
first kernel launch (or an explicit :func:`load_library`).  Each C entry
point returns ``cudaGetLastError()``; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["BuildInfo", "build", "build_info", "load_library", "function",
           "check", "stream_of", "require", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

# ctypes argument kinds used by the kernel modules' signatures.
PTR = ctypes.c_void_p
I64 = ctypes.c_int64
F64 = ctypes.c_double


@dataclass
class BuildInfo:
    """Where the library is, how long the build took (0.0 when reused)
    and what ``ptxas -v`` reported per source."""

    path: Path
    seconds: float
    log: str


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None
_fns: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile (or reuse) the kernel library; returns its :class:`BuildInfo`.

    Raises ``RuntimeError`` with the compiler output when a source fails.
    """
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out_dir = BUILD_DIR / _key()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return BuildInfo(lib_path, 0.0, "")
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    return BuildInfo(lib_path, time.perf_counter() - t0, "\n".join(logs))


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use.

    Raises ``RuntimeError`` when CUDA is unavailable or the build fails;
    there is no fallback.
    """
    global _lib, _info
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA kernel requested but no CUDA device is available")
            _info = build()
            _lib = ctypes.CDLL(str(_info.path))
        return _lib


def build_info() -> Optional[BuildInfo]:
    """The :class:`BuildInfo` of the loaded library (None before load)."""
    return _info


def function(name: str, argtypes: Sequence) -> object:
    """A C entry point of the library with its ctypes signature set."""
    fn = _fns.get(name)
    if fn is None:
        lib = load_library()
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(tensors: Dict[str, torch.Tensor], dtype: torch.dtype,
            device: torch.device) -> None:
    """Raise unless every tensor is a contiguous ``dtype`` on ``device``."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
