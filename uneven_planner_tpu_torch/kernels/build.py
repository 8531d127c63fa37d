"""Building and loading the package's CUDA libraries.

Each `csrc/*.cu` file has a plain C interface and becomes one shared library,
compiled at first use with `nvcc` for `sm_90a` into `_build/` beside the
package (listed in `.gitignore`), keyed by a hash of the source and the
flags, and loaded with ctypes.  Importing the package needs no toolchain.
`build_all` starts one `nvcc` per library at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class CudaLibrary:
    """One `csrc/<name>.cu` and the shared library built from it.

    `declare(lib)` sets the argument and result types of the library's C
    functions once it is loaded.  `build_log` keeps the compiler's output
    (with `-Xptxas -v` register counts) of the build this process ran."""

    def __init__(self, name: str, declare):
        self.name = name
        self.source = os.path.join(_PKG, "csrc", f"{name}.cu")
        self.build_log = ""
        self._declare = declare
        self._lock = threading.Lock()
        self._lib = None

    def path(self) -> str:
        h = hashlib.sha256()
        with open(self.source, "rb") as f:
            h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}_{h.hexdigest()[:16]}.so")

    def _start(self):
        """Start nvcc unless this source is built already: (path, tmp,
        process or None)."""
        out = self.path()
        if os.path.exists(out):
            return out, None, None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return out, tmp, proc

    def _finish(self, out, tmp, proc) -> str:
        if proc is not None:
            self.build_log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, out)
        return out

    def build(self) -> str:
        """Compile if this source has not been built yet; returns the
        library's path."""
        return self._finish(*self._start())

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._declare(lib)
                self._lib = lib
        return self._lib


def build_all(libraries) -> list:
    """Build several libraries with their compilers running side by side;
    returns their paths.  Every compiler is waited for before a failure of
    one of them is raised."""
    started = [(lib, lib._start()) for lib in libraries]
    paths, errors = [], []
    for lib, job in started:
        try:
            paths.append(lib._finish(*job))
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return paths
