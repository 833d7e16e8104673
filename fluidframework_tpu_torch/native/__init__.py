"""The native merge-tree engine (hostmerge.cpp), bound via ctypes.

Copied from fluidframework_tpu/native/__init__.py (`load_hostmerge`
and its builder) together with a copy of its C++ source. The port
uses it as the view oracle of `testing.synthetic.generate_lagged_stream`
and binds only the nine `hm_*` entry points that generator calls; the
rest of the C++ engine's entry points are left unbound.
The library is built by g++ at first use into the repository's
gitignored ``build/torch_kernels/`` directory.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

from ..ops._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_HM_SRC = os.path.join(_DIR, "hostmerge.cpp")
_HM_LIB = os.path.join(BUILD_DIR, "_hostmerge.so")
_lock = threading.Lock()
_hm_lib: Optional[ctypes.CDLL] = None
_hm_failed = False


def _build_lib(src: str, lib: str) -> bool:
    # Link to a process-unique temp path and rename atomically:
    # several processes may build concurrently, and dlopen must never
    # see a half-written .so.
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_hostmerge() -> Optional[ctypes.CDLL]:
    """The hostmerge shared library, building on first use; None when
    unavailable (no compiler)."""
    global _hm_lib, _hm_failed
    with _lock:
        if _hm_lib is not None:
            return _hm_lib
        if _hm_failed:
            return None
        try:
            stale = not os.path.exists(_HM_LIB) or (
                os.path.getmtime(_HM_LIB) < os.path.getmtime(_HM_SRC)
            )
        except OSError:
            # Source missing but a prebuilt .so exists: use it.
            stale = not os.path.exists(_HM_LIB)
        if stale:
            if not _build_lib(_HM_SRC, _HM_LIB):
                _hm_failed = True
                return None
        try:
            lib = ctypes.CDLL(_HM_LIB)
        except OSError:
            _hm_failed = True
            return None
        i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.hm_new.restype = p
        lib.hm_new.argtypes = [i32]
        lib.hm_free.argtypes = [p]
        lib.hm_load.argtypes = [p, ip, i64]
        lib.hm_pack_settled.argtypes = [p]
        lib.hm_set_current_seq.argtypes = [p, i32]
        lib.hm_update_min_seq.argtypes = [p, i32]
        lib.hm_insert.restype = i32
        lib.hm_insert.argtypes = [p, i64, ip, i64, i32, i32, i32, ip, ip, i32]
        lib.hm_remove.restype = i32
        lib.hm_remove.argtypes = [p, i64, i64, i32, i32, i32]
        lib.hm_visible_length.restype = i64
        lib.hm_visible_length.argtypes = [p, i32, i32]
        _hm_lib = lib
        return _hm_lib
