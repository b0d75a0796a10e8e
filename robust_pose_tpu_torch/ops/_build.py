"""Build and load the port's CUDA C++ kernels.

Every ``robust_pose_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, on first use,
into ``build/robust_pose_tpu_torch/<hash of the sources and flags>/``. All
sources are compiled at once, one ``nvcc`` process each, in parallel. The
libraries are loaded with ``ctypes``; each C entry returns
``cudaGetLastError()`` after its launches and :func:`check` raises on a
non-zero code. Nothing here runs at import time.
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

_PKG = Path(__file__).resolve().parents[1]
_SRC_DIR = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "robust_pose_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # nvcc output per source (ptxas register use)
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(_SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every CUDA source; returns the loaded
    libraries by source stem. Idempotent and thread-safe."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        out = _build_dir()
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src in _sources():
            so = out / f"lib{src.stem}.so"
            if so.exists():
                continue
            tmp = out / f".lib{src.stem}.{os.getpid()}.so"
            procs[src.stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, so)
        failed = []
        for stem, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            build_log[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in _sources():
            _libs[src.stem] = ctypes.CDLL(str(out / f"lib{src.stem}.so"))
        build_seconds = time.perf_counter() - t0
        return _libs


_fns: dict[tuple[str, str], object] = {}


def function(stem: str, name: str, argtypes: list):
    """The C entry ``name`` of ``csrc/<stem>.cu`` with its argument types
    declared (``c_void_p`` for every pointer and the stream) and an int
    return (the CUDA error code)."""
    key = (stem, name)
    if key not in _fns:
        fn = getattr(build_all()[stem], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as the address a C entry
    takes (an int: ``c_void_p`` argument types convert it). Read straight
    from the binding that ``torch.cuda.current_stream`` wraps: building
    the ``Stream`` object costs the host more than the launch itself."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
