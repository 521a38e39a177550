"""Blind-spot primitives: shifts, 90-degree rotations, shifted convolution.

PyTorch port of `spr_pick_tpu/models/blindspot.py` (parity:
`spr_pick/models/utility.py:46-72`, `spr_pick/models/joint_network_v2.py:565-584`,
`spr_pick/utils/data.py:43-68`).

The public functions take NHWC like the JAX package (``h_dim=1, w_dim=2``);
the modules compute in NCHW internally and pass ``h_dim=2, w_dim=3``.
Rotations are built from the same flips and transposes as the JAX
``rotate``, and the tests hold them to it exactly.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def shift_down(x: torch.Tensor, rows: int = 1, h_dim: int = 1) -> torch.Tensor:
    """Shift image content down by ``rows`` (zero-fill at top).

    Parity: Shift2d((rows, 0)) — spr_pick/models/utility.py:46-72.
    """
    if rows == 0:
        return x
    h = x.shape[h_dim]
    top = torch.zeros_like(x.narrow(h_dim, 0, rows))
    return torch.cat([top, x.narrow(h_dim, 0, h - rows)], dim=h_dim)


def rotate(x: torch.Tensor, angle: int, h_dim: int = 1,
           w_dim: int = 2) -> torch.Tensor:
    """Rotate images clockwise by multiples of 90 degrees.

    Parity: spr_pick/utils/data.py:43-68; the same flip/transpose pairs as
    `spr_pick_tpu.models.blindspot.rotate`.
    """
    if angle == 0:
        return x
    if angle == 90:
        return torch.flip(x, (w_dim,)).transpose(h_dim, w_dim)
    if angle == 180:
        return torch.flip(x, (w_dim, h_dim))
    if angle == 270:
        return torch.flip(x, (h_dim,)).transpose(h_dim, w_dim)
    raise NotImplementedError("Must be rotation divisible by 90 degrees")


def rot4_stack(x: torch.Tensor, h_dim: int = 1, w_dim: int = 2) -> torch.Tensor:
    """B,H,W,C -> 4B,H,W,C with rotations (0, 90, 180, 270)."""
    return torch.cat(
        [rotate(x, r, h_dim, w_dim) for r in (0, 90, 180, 270)], dim=0
    )


def rot4_unstack(x: torch.Tensor, h_dim: int = 1, w_dim: int = 2,
                 c_dim: int = -1) -> torch.Tensor:
    """4B,H,W,C -> B,H,W,4C; un-rotates chunks with (0, 270, 180, 90).

    Parity: joint_network_v2.py:234-239.
    """
    chunks = torch.chunk(x, 4, dim=0)
    aligned = [
        rotate(c, r, h_dim, w_dim) for c, r in zip(chunks, (0, 270, 180, 90))
    ]
    return torch.cat(aligned, dim=c_dim)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: Optional[torch.dtype],
           stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """VALID conv of ``x`` (NCHW) with ``conv``'s parameters, computed in
    ``dtype`` (None: float32).  Input, weight and bias are cast explicitly,
    like flax's ``nn.Conv(dtype=...)``; parameters stay float32.

    In a reduced-precision dtype the bias is a second op, as in flax's
    ``nn.Conv`` and `spr_pick_tpu/ops/dense_unet.py:_shift_conv_xla`: the
    conv is rounded to ``dtype``, then the bias of ``dtype`` is added and
    the sum rounded again.  cuDNN's path already adds it so; oneDNN fuses
    it into the conv, one rounding, and differs in about a quarter of bf16
    elements."""
    cd = dtype or torch.float32
    w = conv.weight.to(cd)
    if conv.bias is None or cd == torch.float32:
        bias = None if conv.bias is None else conv.bias.to(cd)
        return F.conv2d(x.to(cd), w, bias, stride=stride, dilation=dilation)
    y = F.conv2d(x.to(cd), w, None, stride=stride, dilation=dilation)
    return y.add_(conv.bias.to(cd)[:, None, None])


@functools.lru_cache(maxsize=None)
def _slope_in(negative_slope: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(negative_slope, dtype=dtype))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU whose slope is a constant of ``x``'s dtype, as in the JAX
    package's ``jnp.where(x >= 0, x, x * 0.1)`` and flax's
    ``nn.leaky_relu``, where the Python scalar takes the array's dtype: in
    bf16 the slope is bf16(0.1) = 0.10009765625, not 0.1.  Float32 is
    unchanged (float32(0.1) either way)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        negative_slope = _slope_in(negative_slope, x.dtype)
    return F.leaky_relu(x, negative_slope)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool (NCHW), floor semantics like MaxPool2d(2)."""
    return F.max_pool2d(x, 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


# Initialisers, as variance scales over fan_in (parity with the flax
# initialisers of `spr_pick_tpu/models/blindspot.py:28-37`).
KAIMING_LEAKY_01 = 2.0 / (1.0 + 0.1 ** 2)  # kaiming_normal_(w, a=0.1)
KAIMING_LINEAR = 1.0                         # kaiming_normal_(linear)


def normal_init_(w: torch.Tensor, scale: float,
                 generator: torch.Generator) -> None:
    fan_in = w[0].numel()
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator)
                * math.sqrt(scale / fan_in))


def torch_conv_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """torch's default Conv2d weight init: U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(w[0].numel())
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)


class ShiftConv(nn.Module):
    """Convolution whose receptive field is strictly above the current row.

    One conv on an input padded (top 2*(k//2), bottom 0, left/right k//2)
    — the reference's pad-top / SAME-conv / crop-bottom (`ShiftConv2d`,
    joint_network_v2.py:565-584).  ``blindspot=False`` pads symmetrically
    (a plain SAME conv).  k=1 takes no pad.  NCHW in and out.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 blindspot: bool = True, init_scale: float = KAIMING_LEAKY_01,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.blindspot = blindspot
        self.init_scale = init_scale
        self.dtype = dtype
        self.conv = nn.Conv2d(in_features, features, kernel_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_init_(self.conv.weight, self.init_scale, generator)
        with torch.no_grad():
            self.conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.kernel_size // 2
        if half:
            top = 2 * half if self.blindspot else half
            bottom = 0 if self.blindspot else half
            x = F.pad(x, (half, half, top, bottom))
        return conv2d(x, self.conv, self.dtype)
