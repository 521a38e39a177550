"""The port's CUDA kernels as shared libraries: built with ``nvcc`` for
``sm_90a`` from a source under ``csrc/`` at first use, into
``build/torch_kernels/`` beside the package (listed in .gitignore), with a
plain C interface loaded by ctypes.

A library's file name carries its source's hash, so an edit rebuilds and a
later process reuses the build; the compiler writes a temporary file that
is renamed into place, so concurrent builds never load a half-written
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

from spr_pick_tpu_torch.utils import profiling

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc(source: Path) -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found: csrc/{source.name} is built at "
                           "first use and needs the CUDA toolkit")
    return found


class CudaLibrary:
    """One kernel library, compiled and loaded on first use; its load is
    span ``span`` with attribute ``built``.  A subclass declares the C
    functions' argument and result types in `declare`."""

    def __init__(self, source: Path, stem: str, span: str):
        self.source, self.stem, self.span = source, stem, span
        self._lib = None
        self.build_log = ""

    def build(self) -> Tuple[Path, bool]:
        """Compile the source unless a library of this exact source exists;
        returns the library's path and whether nvcc ran."""
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        path = BUILD_DIR / f"{self.stem}_{digest}.so"
        if path.exists():
            return path, False
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(self.source), *NVCC_FLAGS, "-o", str(tmp),
             str(self.source)],
            capture_output=True, text=True,
        )
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n"
                               f"{self.build_log}")
        os.replace(tmp, path)
        return path, True

    def declare(self, lib: ctypes.CDLL) -> None:
        raise NotImplementedError

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            with profiling.span(self.span) as attrs:
                path, attrs["built"] = self.build()
                lib = ctypes.CDLL(str(path))
            self.declare(lib)
            self._lib = lib
        return self._lib
