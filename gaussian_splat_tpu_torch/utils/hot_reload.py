"""Kernel hot reload: rebuild the CUDA kernels when their sources change,
keeping the last good build.

Counterpart of gaussian_splat_tpu/utils/hot_reload.py, which re-imports a
Python module of Pallas kernels when its mtime changes. Here the "module" is
the CUDA sources — `csrc/*.cu` and `csrc/*.cuh`, the files whose hash names
each library (`_build._source_hash`). On a change the reloader

  1. compiles the changed sources under their new hash and loads every
     library (`_build.build_libraries`),
  2. runs a probe with the new libraries on its own thread (`_build.using`),
  3. and only then swaps them into the process (`_build.install`).

The FIRST build raises like any build (there is nothing to keep). A later
rebuild that fails to compile, or whose probe raises, is printed with its
traceback and changes nothing: the last good libraries stay installed, and
launches go on through them. Nothing ever falls back to a plain version.
"""

from __future__ import annotations

import os
import pathlib
import sys
import traceback
from typing import Callable, Optional, Tuple

from gaussian_splat_tpu_torch import _build


class HotReloader:
    """Watches the CUDA sources of `src_dir` and rebuilds their libraries on
    change.

    Usage:
        reloader = HotReloader(probe=lambda: render_probe_frame())
        reloader.check()   # call every frame; a cheap stat when unchanged

    `probe()` runs with the candidate libraries and must raise if they are
    not good (a CUDA launch error, a wrong frame). `src_dir` defaults to the
    package's csrc/, `build_dir` to its _build/.
    """

    def __init__(
        self,
        probe: Optional[Callable[[], object]] = None,
        src_dir=None,
        build_dir=None,
        verbose: bool = True,
    ):
        self.src_dir = pathlib.Path(src_dir or _build.CSRC_DIR)
        self.build_dir = pathlib.Path(build_dir or _build.BUILD_DIR)
        self.probe = probe
        self.verbose = verbose
        self.reloads = 0  # successful rebuilds after the first build
        self.failures = 0  # rebuilds that were refused
        self.last_error: Optional[str] = None
        self._stamp = self._stat()
        libs = _build.build_libraries(self.src_dir, self.build_dir)
        self._probe(libs)
        _build.install(libs)
        self.libraries = libs

    def _stat(self) -> Tuple:
        """(name, mtime, size) of every watched source."""
        stamp = []
        for path in sorted(self.src_dir.glob("*.cu*")):
            if path.suffix in (".cu", ".cuh"):
                st = os.stat(path)
                stamp.append((path.name, st.st_mtime_ns, st.st_size))
        return tuple(stamp)

    def _probe(self, libs) -> None:
        if self.probe is not None:
            with _build.using(libs):
                self.probe()

    def _refuse(self, what: str) -> bool:
        self.failures += 1
        self.last_error = traceback.format_exc()
        if self.verbose:
            print(f"[hot-reload] {what} in {self.src_dir}; keeping the last good "
                  f"build:\n{self.last_error}", file=sys.stderr, flush=True)
        return False

    def check(self) -> bool:
        """Poll the sources; rebuild if one changed. True if new libraries
        were installed."""
        stamp = self._stat()
        if stamp == self._stamp:
            return False
        self._stamp = stamp
        try:
            libs = _build.build_libraries(self.src_dir, self.build_dir)
        except _build.KernelCompileError:
            return self._refuse("rebuild failed")
        try:
            self._probe(libs)
        except Exception:  # any failure of the probe frame refuses the build
            return self._refuse("probe failed")
        _build.install(libs)
        self.libraries = libs
        self.reloads += 1
        if self.verbose:
            print(f"[hot-reload] rebuilt {', '.join(sorted(libs))} from {self.src_dir}",
                  file=sys.stderr, flush=True)
        return True
