"""The U-Net conv step's epilogue: the bias, the LeakyReLU and the hand-off
to the consuming conv in one pass over channels-last bf16, written straight
into the consumer's padded buffer; and the fold's input launch.  The CUDA
kernels' wrapper and their plain versions.

The kernels are `spr_pick_tpu_torch/csrc/conv_epilogue.cu` (they replace
no Pallas kernel: on the TPU, XLA fused this glue into the conv), built at
first use and loaded with ctypes (`ops/cuda_build.py`).  `conv_epilogue`
takes a conv's (N, H, W, C) bf16 output, computes ``leaky_relu(bf16(y +
b))`` with the slope given (bf16(0.1) in the U-Net), or ``bf16(y + b)``
with ``slope`` None, and moves the values by its hand-off:

- ``"copy"``: as they are;
- ``"pool"``: the 2x2 max pool (H, W even);
- ``"upsample"``: the nearest 2x upsample;
- ``"unrotate"``: the rot4 fold's four lanes of an image (N a multiple of
  4, H == W) un-rotated and side by side in 4C channels (`rot4_unstack`);

``shift`` first shifts the values down a row (`shift_down`, the blind-spot
shift; the U-Net shifts before a pool and at its end, never before an
upsample).  The values land in the first channels of the interior of the
consumer's buffer ``out``, padded by ``pad``; its border, every channel,
is written as zeros (``out`` None: a new buffer of the values' width).  A
pool also writes them into ``skip``'s slot, interior only: the decoder's
concatenation at that level.  The bias ``b`` is the layer's float32
parameter (or a bf16 one), rounded to bf16 as `models/blindspot.py:conv2d`
casts it.  `fold_input` casts the fold's float input to bf16, rotated into
the rot4 fold's lanes or not, into the first conv's buffer (zero channels
up to its width) and the input's slot of the last stage's concatenation.
Each destination a launch writes (an epilogue's ``out`` and ``skip``, the
input launch's two) adds one to counter ``fold.direct``.

A CUDA tensor launches a kernel, a CPU tensor runs the plain version, which
composes the port's staged ops (`conv2d`'s bf16 bias add, `leaky_relu`,
`shift_down`, `F.max_pool2d`, the upsample's broadcast copy,
`rot4_stack`/`rot4_unstack`, a copy into the padded buffer); both give the
same bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from spr_pick_tpu_torch.ops.cuda_build import PKG, CudaLibrary
from spr_pick_tpu_torch.utils import profiling

SOURCE = PKG / "csrc" / "conv_epilogue.cu"
THREADS = 192   # kThreads in csrc/conv_epilogue.cu: a multiple of C / 8
NO_PAD = (0, 0, 0, 0)
HANDOFFS = ("copy", "pool", "upsample", "unrotate")  # the kernel's 0 .. 3

Pad = Tuple[int, int, int, int]  # (top, bottom, left, right)


class Slot(NamedTuple):
    """Channels from ``channel`` of the interior of ``buf``, a contiguous
    NHWC bf16 buffer padded by ``pad``."""

    buf: torch.Tensor
    pad: Pad = NO_PAD
    channel: int = 0


class _Library(CudaLibrary):
    """The epilogue's library; its load is span ``spr.conv.load``."""

    def __init__(self):
        super().__init__(SOURCE, "libspr_conv_epilogue", "spr.conv.load")

    def declare(self, lib: ctypes.CDLL) -> None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.spr_conv_epilogue.argtypes = (
            [ptr, i64, i64, ptr] + [i32] * 5 + [ctypes.c_float, i32, i32, ptr]
            + [i32] * 5 + [ptr] + [i32] * 6 + [ptr])
        lib.spr_conv_epilogue.restype = i32
        lib.spr_fold_input.argtypes = (
            [ptr] + [i64] * 4 + [i32] * 5 + [ptr] + [i32] * 5 + [ptr]
            + [i32] * 6 + [ptr])
        lib.spr_fold_input.restype = i32
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
    _check_pad(pad)


def _check_pad(pad: Pad) -> None:
    if len(pad) != 4 or min(pad) < 0:
        raise ValueError(f"pad is (top, bottom, left, right) >= 0, got {pad}")


def _padded(shape: Tuple[int, int, int, int], pad: Pad):
    """(N, H, W, C) inside ``pad``."""
    n, h, w, c = shape
    top, bottom, left, right = pad
    return n, h + top + bottom, w + left + right, c


def _check_slot(slot: Slot, interior: Tuple[int, int, int, int],
                device: torch.device, what: str) -> None:
    """``slot`` holds ``interior`` (N, H, W, C) in its padded buffer."""
    buf, pad, channel = slot
    _check_pad(pad)
    n, rows, cols, c = _padded(interior, pad)
    if (buf.dtype != torch.bfloat16 or buf.ndim != 4
            or tuple(buf.shape[:3]) != (n, rows, cols)
            or not 0 <= channel <= buf.shape[3] - c
            or not buf.is_contiguous() or buf.device != device):
        raise ValueError(f"{what}: expected a contiguous bf16 buffer of "
                         f"{(n, rows, cols)} pixels on {device} with channels "
                         f"[{channel}, {channel + c}), got {buf.dtype} "
                         f"{tuple(buf.shape)} on {buf.device}")


def _moved_shape(y: torch.Tensor, handoff: str) -> Tuple[int, int, int, int]:
    """The shape of ``y``'s values after ``handoff``."""
    if handoff not in HANDOFFS:
        raise ValueError(f"handoff is one of {HANDOFFS}, got {handoff!r}")
    n, h, w, c = y.shape
    if handoff == "pool":
        if h % 2 or w % 2:
            raise ValueError(f"a pool takes an even height and width, got "
                             f"{(h, w)}")
        return n, h // 2, w // 2, c
    if handoff == "upsample":
        return n, 2 * h, 2 * w, c
    if handoff == "unrotate":
        if n % 4 or h != w:
            raise ValueError(f"unrotate takes 4 square lanes an image, got "
                             f"{tuple(y.shape)}")
        return n // 4, h, w, 4 * c
    return n, h, w, c


def _check_kernel_layout(y: torch.Tensor, bias: torch.Tensor,
                         handoff: str = "copy") -> None:
    """What the kernel reads: 8-channel groups that tile its block, pixels
    and channels contiguous, 16-byte aligned rows and images."""
    c = y.shape[3]
    groups = (4 if handoff == "unrotate" else 1) * (c // 8)
    if c % 8 or THREADS % groups:
        raise ValueError(f"the epilogue kernel takes C a multiple of 8 whose "
                         f"groups of 8 divide {THREADS}; got C = {c} "
                         f"({handoff})")
    if (y.shape[2] > 1 and y.stride(2) != c) or (c > 1 and y.stride(3) != 1):
        raise ValueError(f"the epilogue kernel reads pixels and channels "
                         f"contiguous; the conv output has strides "
                         f"{y.stride()}")
    if (y.stride(0) % 8 or y.stride(1) % 8 or y.data_ptr() % 16
            or not bias.is_contiguous() or bias.data_ptr() % 16):
        raise ValueError("the epilogue kernel reads 16-byte aligned rows, "
                         "images and bias")


def _check_kernel_slot(slot: Slot) -> None:
    """What the kernels write: 16-byte groups of 8 channels."""
    if slot.buf.shape[3] % 8 or slot.channel % 8 or slot.buf.data_ptr() % 16:
        raise ValueError(f"the kernels write 16-byte aligned groups of 8 "
                         f"channels; got {slot.buf.shape[3]} channels from "
                         f"channel {slot.channel}")


def _cuda_only(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the epilogue kernel runs on CUDA tensors only, "
                         f"got {t.device}")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.spr_conv_error_string(rc).decode())


class ConvEpilogueKernel:
    """Launches the epilogue (and the fold's input) on CUDA tensors; counts
    the epilogue's launches in ``launches``, the input's in ``inputs``."""

    def __init__(self):
        self.launches = 0
        self.inputs = 0

    def epilogue(self, y: torch.Tensor, bias: torch.Tensor, pad: Pad,
                 slope: Optional[float], handoff: str = "copy",
                 shift: bool = False, out: Optional[torch.Tensor] = None,
                 skip: Optional[Slot] = None) -> torch.Tensor:
        _check(y, bias, pad)
        _cuda_only(y)
        out, skip = _destinations(y, pad, handoff, shift, out, skip)
        bias = bias.float()  # the kernel rounds it to bf16
        _check_kernel_layout(y, bias, handoff)
        for s in (Slot(out, pad),) + ((skip,) if skip else ()):
            _check_kernel_slot(s)
        n, h, w, c = y.shape
        lib = library.get()
        stream = torch.cuda.current_stream(y.device).cuda_stream
        sbuf, spad, schan = skip if skip else (None, NO_PAD, 0)
        with torch.cuda.device(y.device):
            rc = lib.spr_conv_epilogue(
                y.data_ptr(), y.stride(0), y.stride(1), bias.data_ptr(), n, h,
                w, c, int(slope is not None),
                0.0 if slope is None else slope, HANDOFFS.index(handoff),
                int(shift), out.data_ptr(), out.shape[3], *pad,
                None if sbuf is None else sbuf.data_ptr(),
                0 if sbuf is None else sbuf.shape[3], schan, *spad, stream)
        _raise_on(lib, rc, "conv epilogue")
        self.launches += 1
        return out

    def fold_input(self, x: torch.Tensor, pad: Pad, channels: int,
                   last: Slot, rot4: bool) -> torch.Tensor:
        _cuda_only(x)
        first, lanes = _input_destinations(x, pad, channels, last, rot4)
        if x.dtype != torch.float32:
            x = x.float()  # exact from bf16 and half; the kernel rounds
        for s in (Slot(first, pad), last):
            _check_kernel_slot(s)
        lib = library.get()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        n, h, w, cin = x.shape
        with torch.cuda.device(x.device):
            rc = lib.spr_fold_input(
                x.data_ptr(), *x.stride(), n, h, w, cin, int(rot4),
                first.data_ptr(), channels, *pad, last.buf.data_ptr(),
                last.buf.shape[3], last.channel, *last.pad, stream)
        _raise_on(lib, rc, "fold input")
        self.inputs += 1
        return first


conv_epilogue_cuda = ConvEpilogueKernel()


def _destinations(y: torch.Tensor, pad: Pad, handoff: str, shift: bool,
                  out: Optional[torch.Tensor], skip: Optional[Slot]):
    """The checked (or new) ``out`` buffer and ``skip`` slot of an
    epilogue of ``y``."""
    moved = _moved_shape(y, handoff)
    if shift and handoff == "upsample":
        raise ValueError("an upsample takes no shift")
    if out is None:
        out = torch.empty(_padded(moved, pad), dtype=torch.bfloat16,
                          device=y.device)
    _check_slot(Slot(out, pad), moved, y.device, "out")
    if skip is not None:
        if handoff != "pool":
            raise ValueError(f"only a pool writes a skip slot, not "
                             f"{handoff!r}")
        _check_slot(skip, moved, y.device, "skip")
    return out, skip


def _input_destinations(x: torch.Tensor, pad: Pad, channels: int,
                        last: Slot, rot4: bool):
    """The new first buffer of the fold's input ``x`` and its lane count;
    ``last`` checked."""
    if x.ndim != 4 or not x.is_floating_point():
        raise TypeError(f"expected a (B, H, W, C) float input, got "
                        f"{x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if rot4 and h != w:
        raise ValueError(f"the rot4 fold takes square inputs, got {(h, w)}")
    if channels < cin:
        raise ValueError(f"{channels} channels hold no {cin}-channel input")
    lanes = (4 if rot4 else 1) * n
    first = torch.empty(_padded((lanes, h, w, channels), pad),
                        dtype=torch.bfloat16, device=x.device)
    _check_slot(last, (lanes, h, w, cin), x.device, "last")
    return first, lanes


def _write(slot: Slot, z: torch.Tensor, border: bool) -> None:
    """``z`` (N, H, W, C) into ``slot``'s interior; with ``border``, zeros
    in every channel of the buffer's border."""
    buf, (top, bottom, left, right), channel = slot
    h, w = z.shape[1:3]
    if border:
        buf[:, :top].zero_()
        buf[:, top + h:].zero_()
        buf[:, top:top + h, :left].zero_()
        buf[:, top:top + h, left + w:].zero_()
    buf[:, top:top + h, left:left + w, channel:channel + z.shape[3]] = z


def _moved(z: torch.Tensor, handoff: str, shift: bool) -> torch.Tensor:
    """The staged ops of a hand-off on NHWC ``z``."""
    from spr_pick_tpu_torch.models.blindspot import rot4_unstack, shift_down

    if shift:
        z = shift_down(z, 1, h_dim=1)
    if handoff == "pool":
        return F.max_pool2d(z.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    if handoff == "upsample":
        n, h, w, c = z.shape
        return z[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
            n, 2 * h, 2 * w, c)
    if handoff == "unrotate":
        return rot4_unstack(z)
    return z


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        pad: Pad = NO_PAD, slope: Optional[float] = None,
                        handoff: str = "copy", shift: bool = False,
                        out: Optional[torch.Tensor] = None,
                        skip: Optional[Slot] = None) -> torch.Tensor:
    """The plain PyTorch version of the epilogue kernel."""
    _check(y, bias, pad)
    out, skip = _destinations(y, pad, handoff, shift, out, skip)
    z = y + bias.to(torch.bfloat16)
    if slope is not None:
        z = F.leaky_relu(z, slope)
    z = _moved(z, handoff, shift)
    _write(Slot(out, pad), z, border=True)
    if skip is not None:
        _write(skip, z, border=False)
    return out


def fold_input_plain(x: torch.Tensor, pad: Pad, channels: int, last: Slot,
                     rot4: bool) -> torch.Tensor:
    """The plain PyTorch version of the fold's input launch."""
    from spr_pick_tpu_torch.models.blindspot import rot4_stack

    first, _ = _input_destinations(x, pad, channels, last, rot4)
    lanes = (rot4_stack(x) if rot4 else x).to(torch.bfloat16)
    cin = lanes.shape[3]
    _write(Slot(first, pad), F.pad(lanes, (0, channels - cin)), border=True)
    tail = last.buf.shape[3] - last.channel
    _write(last, F.pad(lanes, (0, tail - cin)), border=False)
    return first


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, pad: Pad = NO_PAD,
                  slope: Optional[float] = None, handoff: str = "copy",
                  shift: bool = False, out: Optional[torch.Tensor] = None,
                  skip: Optional[Slot] = None) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    fn = (conv_epilogue_plain if y.device.type == "cpu"
          else conv_epilogue_cuda.epilogue)
    out = fn(y, bias, pad, slope, handoff, shift, out, skip)
    profiling.count("fold.direct", 1 if skip is None else 2)
    return out


def fold_input(x: torch.Tensor, pad: Pad, channels: int, last: Slot,
               rot4: bool) -> torch.Tensor:
    """The fold's input: a new ``channels``-wide buffer padded by ``pad``
    holding ``x`` (B, H, W, Cin) in bf16 (rot4: its four rotations (0, 90,
    180, 270) as 4B lanes, `rot4_stack`'s order), zeros past Cin; and the
    same lanes in ``last``'s slot, zeros to the buffer's last channel."""
    fn = (fold_input_plain if x.device.type == "cpu"
          else conv_epilogue_cuda.fold_input)
    first = fn(x, pad, channels, last, rot4)
    profiling.count("fold.direct", 2)
    return first
