"""The U-Net conv step's epilogue: the bias, the LeakyReLU and the next
conv's zero pad in one pass over channels-last bf16 — the CUDA kernel's
wrapper and its plain version.

The kernel is `spr_pick_tpu_torch/csrc/conv_epilogue.cu` (it replaces no
Pallas kernel: on the TPU, XLA fused this glue into the conv), built at
first use and loaded with ctypes (`ops/cuda_build.py`).  `conv_epilogue`
takes a conv's (N, H, W, C) bf16 output and writes the (N, H + top +
bottom, W + left + right, C) input of the conv that consumes it: zeros in
the pad, ``leaky_relu(bf16(y + b))`` in the interior with the slope given
(bf16(0.1) in the U-Net), or ``bf16(y + b)`` with ``slope`` None.  The
bias ``b`` is the layer's float32 parameter (or a bf16 one), rounded to
bf16 as `models/blindspot.py:conv2d` casts it.  A CUDA tensor launches
the kernel, a CPU tensor runs the plain version; both compute the port's
two-op chain (`conv2d`'s bf16 bias add, then `leaky_relu`) bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spr_pick_tpu_torch.ops.cuda_build import PKG, CudaLibrary

SOURCE = PKG / "csrc" / "conv_epilogue.cu"
THREADS = 192   # kThreads in csrc/conv_epilogue.cu: a multiple of C / 8
NO_PAD = (0, 0, 0, 0)

Pad = Tuple[int, int, int, int]  # (top, bottom, left, right)


class _Library(CudaLibrary):
    """The epilogue's library; its load is span ``spr.conv.load``."""

    def __init__(self):
        super().__init__(SOURCE, "libspr_conv_epilogue", "spr.conv.load")

    def declare(self, lib: ctypes.CDLL) -> None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.spr_conv_epilogue.argtypes = [ptr, i64, i64, ptr, ptr, i32, i32,
                                          i32, i32, i32, i32, i32, i32, i32,
                                          ctypes.c_float, ptr]
        lib.spr_conv_epilogue.restype = i32
        lib.spr_conv_error_string.argtypes = [i32]
        lib.spr_conv_error_string.restype = ctypes.c_char_p


library = _Library()


def _check(y: torch.Tensor, bias: torch.Tensor, pad: Pad) -> None:
    if y.ndim != 4 or y.dtype != torch.bfloat16:
        raise TypeError(f"expected a (N, H, W, C) bf16 conv output, got "
                        f"{y.dtype} {tuple(y.shape)}")
    if (bias.dtype not in (torch.float32, torch.bfloat16)
            or tuple(bias.shape) != (y.shape[3],)):
        raise TypeError(f"expected a float32 or bf16 bias of {y.shape[3]} "
                        f"channels, got {bias.dtype} {tuple(bias.shape)}")
    if bias.device != y.device:
        raise ValueError(f"bias on {bias.device}, conv output on {y.device}")
    if len(pad) != 4 or min(pad) < 0:
        raise ValueError(f"pad is (top, bottom, left, right) >= 0, got {pad}")


def _check_kernel_layout(y: torch.Tensor, bias: torch.Tensor) -> None:
    """What the kernel reads: 8-channel groups that tile its block, pixels
    and channels contiguous, 16-byte aligned rows and images."""
    c = y.shape[3]
    if c % 8 or THREADS % (c // 8):
        raise ValueError(f"the epilogue kernel takes C a multiple of 8 whose "
                         f"groups of 8 divide {THREADS}; got C = {c}")
    if (y.shape[2] > 1 and y.stride(2) != c) or (c > 1 and y.stride(3) != 1):
        raise ValueError(f"the epilogue kernel reads pixels and channels "
                         f"contiguous; the conv output has strides "
                         f"{y.stride()}")
    if (y.stride(0) % 8 or y.stride(1) % 8 or y.data_ptr() % 16
            or not bias.is_contiguous() or bias.data_ptr() % 16):
        raise ValueError("the epilogue kernel reads 16-byte aligned rows, "
                         "images and bias")


class ConvEpilogueKernel:
    """Launches the epilogue on CUDA tensors; counts its launches in
    ``launches``."""

    def __init__(self):
        self.launches = 0

    def epilogue(self, y: torch.Tensor, bias: torch.Tensor, pad: Pad,
                 slope: Optional[float]) -> torch.Tensor:
        _check(y, bias, pad)
        if y.device.type != "cuda":
            raise ValueError(f"the epilogue kernel runs on CUDA tensors "
                             f"only, got {y.device}")
        bias = bias.float()  # the kernel rounds it to bf16
        _check_kernel_layout(y, bias)
        n, h, w, c = y.shape
        top, bottom, left, right = pad
        out = torch.empty((n, h + top + bottom, w + left + right, c),
                          dtype=torch.bfloat16, device=y.device)
        lib = library.get()
        stream = torch.cuda.current_stream(y.device).cuda_stream
        with torch.cuda.device(y.device):
            rc = lib.spr_conv_epilogue(
                y.data_ptr(), y.stride(0), y.stride(1), bias.data_ptr(),
                out.data_ptr(), n, h, w, c, top, bottom, left, right,
                int(slope is not None), 0.0 if slope is None else slope,
                stream)
        if rc != 0:
            raise RuntimeError("conv epilogue launch failed: "
                               + lib.spr_conv_error_string(rc).decode())
        self.launches += 1
        return out


conv_epilogue_cuda = ConvEpilogueKernel()


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        pad: Pad = NO_PAD,
                        slope: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the epilogue kernel."""
    _check(y, bias, pad)
    z = y + bias.to(torch.bfloat16)
    if slope is not None:
        z = F.leaky_relu(z, slope)
    top, bottom, left, right = pad
    if any(pad):
        z = F.pad(z, (0, 0, left, right, top, bottom))
    return z.contiguous()


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, pad: Pad = NO_PAD,
                  slope: Optional[float] = None) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if y.device.type == "cpu":
        return conv_epilogue_plain(y, bias, pad, slope)
    return conv_epilogue_cuda.epilogue(y, bias, pad, slope)

