"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point. It
is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under the repository's gitignored ``build/torch_kernels/`` directory
at first use, and loaded with ctypes: no PyTorch headers, so a build
takes seconds. The library's file name carries a hash of the source
and flags, so an edited source is rebuilt and a stale one never
loaded. Nothing is built or imported while this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
        "from csrc/ at first use"
    )


def build(name: str) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` if needed; returns (library path,
    compiler output: ptxas register and shared-memory report)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library, building it on first use. One lock a
    kernel: threads loading different kernels run their nvcc builds
    side by side."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            path, log = build(name)
            build_logs[name] = log
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def launch(name: str, fn, device, ints: Sequence[int], tensors) -> None:
    """Call a kernel's C entry point ``fn(device_index, *ints, n_ptrs,
    ptrs, stream)`` with the tensors' data pointers (None passes a null
    pointer), on PyTorch's current stream of `device`, without
    synchronising; raises if the entry point returns a CUDA error (a
    refused launch never runs, and a later synchronise would not report
    it)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    rc = fn(index, *ints, len(tensors), ptrs, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
