"""Builds the hand-written CUDA kernels of csrc/ and loads them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library `_build/<name>-<hash>.so`, compiled by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v

at first use and keyed by a hash of the source and the flags (no
`torch/extension.h`: a file like this builds in seconds). `build_all()` starts
one `nvcc` per source at once. The compiler's report (registers, shared
memory, spills) is kept beside each library as `<name>-<hash>.log`.

Importing this module — and the package — needs no `nvcc`: nothing is built
until the first CUDA launch asks for its library. A failed build raises; no
caller catches it to carry on without the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    pass


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelCompileError(
        "nvcc not found (looked on PATH and under $CUDA_HOME, /usr/local/cuda): "
        "the CUDA kernels of gaussian_splat_tpu_torch are built from csrc/ at "
        "first use and need the CUDA toolkit"
    )


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{_source_hash(name)}.so"


def _start_build(name: str) -> Optional[tuple]:
    """Start nvcc for one source unless its library is already built.
    Returns (process, tmp_path, final_path) or None."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise KernelCompileError(f"no kernel source {src}")
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, started: tuple) -> None:
    proc, tmp, out = started
    report, _ = proc.communicate()
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise KernelCompileError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{report}"
        )
    out.with_suffix(".log").write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing


def build_all() -> Dict[str, object]:
    """Build every kernel of csrc/, one nvcc per source, all started together.
    Returns {"seconds": wall time, "libraries": {name: path}, "reports":
    {name: compiler report}}."""
    t0 = time.perf_counter()
    with _lock:
        started = {name: _start_build(name) for name in kernel_names()}
        for name, st in started.items():
            if st is not None:
                _finish_build(name, st)
    names = kernel_names()
    return {
        "seconds": time.perf_counter() - t0,
        "libraries": {n: str(library_path(n)) for n in names},
        "reports": {n: compiler_report(n) for n in names},
    }


def compiler_report(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(name, started)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
    return lib
