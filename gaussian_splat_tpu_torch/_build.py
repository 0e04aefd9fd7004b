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

Hot reload (utils/hot_reload.py) builds a whole set of libraries from a
source directory with `build_libraries`, runs a probe frame with them in
place of the loaded ones on its own thread only (`using`), and only then
swaps them into the process (`install`). The replaced libraries stay loaded
and referenced: a shared library with kernels in it cannot be unloaded
safely.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Mapping, Optional

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_retired: List[ctypes.CDLL] = []  # replaced by `install`, never unloaded
_trial = threading.local()  # `using`: this thread's libraries under probe


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


def _dirs(src_dir=None, build_dir=None):
    return (pathlib.Path(src_dir or CSRC_DIR), pathlib.Path(build_dir or BUILD_DIR))


def kernel_names(src_dir=None) -> List[str]:
    src, _ = _dirs(src_dir)
    return sorted(p.stem for p in src.glob("*.cu"))


def _source_hash(name: str, src_dir=None) -> str:
    src, _ = _dirs(src_dir)
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [src / f"{name}.cu", *sorted(src.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, src_dir=None, build_dir=None) -> pathlib.Path:
    _, out_dir = _dirs(src_dir, build_dir)
    return out_dir / f"{name}-{_source_hash(name, src_dir)}.so"


def _start_build(name: str, src_dir=None, build_dir=None) -> Optional[tuple]:
    """Start nvcc for one source unless its library is already built.
    Returns (process, tmp_path, final_path) or None."""
    src_root, out_dir = _dirs(src_dir, build_dir)
    src = src_root / f"{name}.cu"
    if not src.exists():
        raise KernelCompileError(f"no kernel source {src}")
    out = library_path(name, src_dir, build_dir)
    if out.exists():
        return None
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(src_root), "-o", str(tmp), str(src)]
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


def _build_parallel(names, src_dir=None, build_dir=None) -> None:
    """One nvcc per source, all started together; every process is waited
    for before the first failure is raised."""
    started = {name: _start_build(name, src_dir, build_dir) for name in names}
    errors = []
    for name, st in started.items():
        if st is not None:
            try:
                _finish_build(name, st)
            except KernelCompileError as e:
                errors.append(e)
    if errors:
        raise errors[0]


def build_all() -> Dict[str, object]:
    """Build every kernel of csrc/, one nvcc per source, all started together.
    Returns {"seconds": wall time, "libraries": {name: path}, "reports":
    {name: compiler report}}."""
    t0 = time.perf_counter()
    with _lock:
        _build_parallel(kernel_names())
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
    """The shared library of csrc/<name>.cu, built first if need be (inside
    `using`, the library under probe on this thread)."""
    trial = getattr(_trial, "libs", None)
    if trial is not None and name in trial:
        return trial[name]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(name, started)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
    return lib


def build_libraries(src_dir=None, build_dir=None) -> Dict[str, ctypes.CDLL]:
    """Build and load the library of every kernel of `src_dir` (default:
    csrc/) into `build_dir` (default: _build/); a source whose hash is
    unchanged is not compiled again. The libraries are returned, not
    installed. Raises KernelCompileError if any source fails to compile."""
    names = kernel_names(src_dir)
    with _lock:
        _build_parallel(names, src_dir, build_dir)
    return {n: ctypes.CDLL(str(library_path(n, src_dir, build_dir))) for n in names}


@contextlib.contextmanager
def using(libs: Mapping[str, ctypes.CDLL]):
    """Launches made on THIS thread inside the scope go to `libs` (a probe
    frame); other threads keep the installed libraries."""
    before = getattr(_trial, "libs", None)
    _trial.libs = dict(libs)
    try:
        yield
    finally:
        _trial.libs = before


def install(libs: Mapping[str, ctypes.CDLL]) -> None:
    """Make `libs` the process's libraries. Each one replaced stays loaded
    and referenced (`_retired`)."""
    with _lock:
        for name, lib in libs.items():
            old = _libs.get(name)
            if old is not None and old is not lib:
                _retired.append(old)
            _libs[name] = lib
