"""Build the port's hand-written CUDA sources at first use and load them.

Each `CudaLibrary` is one shared library with a plain C interface, compiled
by `nvcc` for Hopper (`sm_90a`) from the sources in this checkout and
loaded with `ctypes`. The library file is named by a hash of its sources
and flags and lives under `<checkout>/build/kernels/`, so an unchanged
library is built once per checkout and a changed source is rebuilt. The
compile writes to a per-process temporary name and is renamed into place,
so concurrent processes never load a half-written file.

`nvcc` comes from `PATH`, else from `$CUDA_HOME/bin` (CUDA_HOME defaulting
to the toolkit's standard `/usr/local/cuda`). Without it a build raises.
Nothing here runs at import time.
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
from typing import Optional, Sequence

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # register / shared-memory / spill report in the log
)

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (CUDA_HOME="
        f"{home!r}); the CUDA toolkit is needed to build the port's kernels")


class CudaLibrary:
    """One nvcc-built shared library, loaded once per process."""

    def __init__(self, name: str, sources: Sequence[Path]):
        self.name = name
        self.sources = tuple(Path(s) for s in sources)
        self.build_seconds: Optional[float] = None  # set when this process built it
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        h = hashlib.sha256()
        for src in self.sources:
            h.update(src.read_bytes())
        h.update("\0".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    @property
    def log_path(self) -> Path:
        return self.path.with_suffix(".log")

    def build(self) -> Path:
        """Compile the library unless it is already built; raises with
        nvcc's output if the compile fails. Returns the library's path."""
        path = self.path
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, self.sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed building {self.name} "
                f"(exit {proc.returncode}):\n{proc.stdout}")
        self.log_path.write_text(proc.stdout)
        os.replace(tmp, path)
        self.build_seconds = time.perf_counter() - t0
        return path

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self.build()))
            return self._lib

    def ptxas_report(self) -> str:
        """nvcc's -Xptxas -v lines (registers, shared memory, spills)."""
        if not self.log_path.exists():
            return ""
        return "\n".join(line for line in self.log_path.read_text().splitlines()
                         if "ptxas" in line or "spill" in line)
