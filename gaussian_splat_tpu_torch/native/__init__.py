"""Native (C++) PLY (de)interleaver, built with g++ on first use, loaded with
ctypes.

Counterpart of gaussian_splat_tpu/native/__init__.py, with its own copy of
gsply.cpp. The library is built into the package's git-ignored
`_build/native/` directory as `libgsply-<hash>.so` (the hash covers the
source and the flags), never beside the source, and apart from the CUDA
kernels' libraries in `_build/`.

The numpy path of io/ply.py stays: it is the documented path for machines
without a compiler. Which path a read took is never silent: a failed build
prints one warning to stderr, and `io.ply.last_read_path` names the path of
the last read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
import threading
from typing import Optional

SRC = pathlib.Path(__file__).resolve().parent / "gsply.cpp"
BUILD_DIR = SRC.parents[1] / "_build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

# dtype string (numpy) -> native enum in gsply.cpp
DTYPE_ENUM = {
    "<f4": 0, "f4": 0,
    "<f8": 1, "f8": 1,
    "i1": 2,
    "u1": 3,
    "<i2": 4, "i2": 4,
    "<u2": 5, "u2": 5,
    "<i4": 6, "i4": 6,
    "<u4": 7, "u4": 7,
}


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libgsply-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> None:
    """Compile gsply.cpp into `out` (atomically: a concurrent process sees
    all of the library or none). Raises on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
            check=True, capture_output=True, text=True, timeout=120,
        )
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, building it on first use; None if it cannot be
    built or loaded (after one warning on stderr)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or e
            print(f"gaussian_splat_tpu_torch.native: cannot build or load {out.name} "
                  f"({detail}); PLY files are read and written by the numpy path",
                  file=sys.stderr)
            _build_failed = True
            return None
        lib.gsply_deinterleave.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int32,
        ]
        lib.gsply_deinterleave.restype = None
        lib.gsply_interleave_f32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.gsply_interleave_f32.restype = None
        _lib = lib
        return _lib
