"""K1: exact greedy NMS — the CUDA kernel's wrapper and its plain version.

Replaces `spr_pick_tpu/ops/nms_pallas.py` (the JAX package's only Pallas
kernel).  The kernel is `spr_pick_tpu_torch/csrc/nms.cu`, compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface at
first use, into ``build/torch_kernels/`` beside the package (listed in
.gitignore), and loaded with ctypes.

`greedy_nms` is the entry point: a CUDA tensor launches the kernel (one
launch for the whole (B, H, W) batch), a CPU tensor runs
`greedy_nms_plain`, the same row-max greedy loop as tensor ops.  Both
return (scores (B, K) f32, coords (B, K, 2) int32 as (x, y), counts (B,)
int32) with entries past the count at 0, and both leave the caller's
heatmaps untouched: they work on a contiguous copy, seeded with -inf at
``suppressed`` pixels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "nms.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

NmsResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: K1 is built from csrc/nms.cu at "
                           "first use and needs the CUDA toolkit")
    return found


class _Library:
    """The built kernel library; compiled and loaded on first use."""

    def __init__(self):
        self._lib = None
        self._max_rows = {}
        self.build_log = ""

    def build(self) -> Path:
        """Compile csrc/nms.cu unless a library of this exact source exists.

        The file name carries the source's hash, so an edit rebuilds; the
        compiler writes a temporary file that is renamed into place, so
        concurrent builds never load a half-written library."""
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        path = BUILD_DIR / f"libspr_nms_{digest}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{self.build_log}")
            os.replace(tmp, path)
        return path

    def get(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.spr_nms_greedy.argtypes = [ptr, i32, i32, i32, i32,
                                           ctypes.c_float, i32, ptr, ptr, ptr,
                                           ptr]
            lib.spr_nms_greedy.restype = i32
            lib.spr_nms_max_rows.argtypes = [i32]
            lib.spr_nms_max_rows.restype = i32
            lib.spr_cuda_error_string.argtypes = [i32]
            lib.spr_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def max_rows(self, device_index: int) -> int:
        """Rows K1's shared-memory row-max cache holds on this device."""
        if device_index not in self._max_rows:
            lib = self.get()
            rows = lib.spr_nms_max_rows(device_index)
            if rows < 0:
                raise RuntimeError(
                    f"K1 cannot query device {device_index}: "
                    + lib.spr_cuda_error_string(-rows).decode()
                )
            self._max_rows[device_index] = rows
        return self._max_rows[device_index]


library = _Library()


def _check_args(heatmaps: torch.Tensor, radius: int, max_peaks: int) -> None:
    if heatmaps.ndim != 3:
        raise ValueError(f"expected (B, H, W) heatmaps, got {tuple(heatmaps.shape)}")
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"expected float32 heatmaps, got {heatmaps.dtype}")
    if radius < 0 or max_peaks < 1:
        raise ValueError(f"need radius >= 0 and max_peaks >= 1, got "
                         f"{radius}, {max_peaks}")


def _work_copy(heatmaps: torch.Tensor,
               suppressed: Optional[torch.Tensor]) -> torch.Tensor:
    """Contiguous copy of the maps with -inf at the suppressed seeds."""
    work = torch.empty(heatmaps.shape, dtype=torch.float32,
                       device=heatmaps.device)
    work.copy_(heatmaps)
    if suppressed is not None:
        work.masked_fill_(
            torch.as_tensor(suppressed, device=work.device).to(torch.bool),
            float("-inf"),
        )
    return work


def _f32(threshold: float) -> float:
    # The kernels compare in float32; round the threshold the same way.
    return float(np.float32(threshold))


class GreedyNmsKernel:
    """Launches K1 on CUDA tensors; counts its launches in ``launches``."""

    def __init__(self):
        self.launches = 0

    def __call__(self, heatmaps: torch.Tensor, radius: int, threshold: float,
                 max_peaks: int, suppressed=None) -> NmsResult:
        if heatmaps.device.type != "cuda":
            raise ValueError(
                f"K1 runs on CUDA tensors only, got {heatmaps.device}; "
                "greedy_nms sends CPU tensors to greedy_nms_plain"
            )
        _check_args(heatmaps, radius, max_peaks)
        b, h, w = heatmaps.shape
        device = heatmaps.device
        lib = library.get()
        max_rows = library.max_rows(device.index or 0)
        if h > max_rows:
            raise ValueError(f"K1's row-max cache holds {max_rows} rows in "
                             f"shared memory; the map has {h}")
        work = _work_copy(heatmaps, suppressed)
        scores = torch.empty((b, max_peaks), dtype=torch.float32, device=device)
        coords = torch.empty((b, max_peaks, 2), dtype=torch.int32, device=device)
        counts = torch.empty((b,), dtype=torch.int32, device=device)
        if b == 0:
            return scores, coords, counts
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = lib.spr_nms_greedy(
                work.data_ptr(), b, h, w, int(radius), _f32(threshold),
                int(max_peaks), scores.data_ptr(), coords.data_ptr(),
                counts.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError("K1 launch failed: "
                               + lib.spr_cuda_error_string(rc).decode())
        self.launches += 1
        return scores, coords, counts


greedy_nms_cuda = GreedyNmsKernel()


def greedy_nms_plain(heatmaps: torch.Tensor, radius: int, threshold: float,
                     max_peaks: int, suppressed=None) -> NmsResult:
    """The plain PyTorch version of K1: the same row-max greedy loop."""
    _check_args(heatmaps, radius, max_peaks)
    b, h, w = heatmaps.shape
    device = heatmaps.device
    work = _work_copy(heatmaps, suppressed)
    scores = torch.zeros((b, max_peaks), dtype=torch.float32, device=device)
    coords = torch.zeros((b, max_peaks, 2), dtype=torch.int32, device=device)
    counts = torch.zeros((b,), dtype=torch.int32, device=device)
    thr = _f32(threshold)
    r = int(radius)
    off = torch.arange(-r, r + 1, device=device)
    disk = off[:, None] ** 2 + off[None, :] ** 2 <= r * r
    for i in range(b):
        wk = work[i]
        rowmax = wk.amax(dim=1)
        k = 0
        while k < max_peaks:
            m = rowmax.max()
            if not float(m) > thr:
                break
            # Highest flat index among ties: last row, then last column.
            y = int(torch.nonzero(rowmax == m)[-1, 0])
            x = int(torch.nonzero(wk[y] == m)[-1, 0])
            scores[i, k] = m
            coords[i, k, 0] = x
            coords[i, k, 1] = y
            y0, y1 = max(0, y - r), min(h, y + r + 1)
            x0, x1 = max(0, x - r), min(w, x + r + 1)
            wk[y0:y1, x0:x1].masked_fill_(
                disk[y0 - y + r:y1 - y + r, x0 - x + r:x1 - x + r],
                float("-inf"),
            )
            rowmax[y0:y1] = wk[y0:y1].amax(dim=1)
            k += 1
        counts[i] = k
    return scores, coords, counts


def greedy_nms(heatmaps: torch.Tensor, radius: int, threshold: float,
               max_peaks: int, suppressed=None) -> NmsResult:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if heatmaps.device.type == "cpu":
        return greedy_nms_plain(heatmaps, radius, threshold, max_peaks,
                                suppressed)
    return greedy_nms_cuda(heatmaps, radius, threshold, max_peaks, suppressed)
