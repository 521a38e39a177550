"""Operation counts of the benchmark's model, from shapes alone.

A convolution of ``cin`` to ``cout`` channels with a k x k kernel costs
2 cin cout k^2 operations an output pixel (one multiply and one add a
weight).  Only convolutions are counted: they are the model's work, and
the element-wise ops around them are memory traffic, not operations.
"""

from __future__ import annotations

from typing import Dict


def conv_flops(cin: int, cout: int, k: int, pixels: int) -> int:
    return 2 * cin * cout * k * k * pixels


def unet_lane_flops(model: Dict, h: int, w: int) -> int:
    """One lane of the blind-spot U-Net's backbone at (h, w): every conv
    keeps its input's size; each level pools by 2."""
    enc, dec = model["enc_features"], model["dec_features"]
    cin, levels = model["in_channels"], model["levels"]
    px = h * w
    total = conv_flops(cin, enc, 3, px) + conv_flops(enc, enc, 3, px)
    for i in range(2, levels + 1):          # enc2 .. enc<levels>
        total += conv_flops(enc, enc, 3, px >> (2 * (i - 1)))
    total += conv_flops(enc, enc, 3, px >> (2 * levels))   # bottom
    for s in range(levels - 1):             # decoder stages, coarse first
        p = px >> (2 * (levels - 1 - s))
        total += conv_flops((enc if s == 0 else dec) + enc, dec, 3, p)
        total += conv_flops(dec, dec, 3, p)
    total += conv_flops(dec + cin, dec, 3, px) + conv_flops(dec, dec, 3, px)
    return total


def unet_fold_flops(model: Dict, h: int, w: int) -> int:
    """The dense rot4 fold: four lanes, then the 1x1 head once."""
    dec, cout = model["dec_features"], model["out_channels"]
    px = h * w
    head = (conv_flops(4 * dec, 4 * dec, 1, px)
            + conv_flops(4 * dec, dec, 1, px) + conv_flops(dec, cout, 1, px))
    return 4 * unet_lane_flops(model, h, w) + head


def resnet8_dense_flops(model: Dict, h: int, w: int) -> int:
    """The dilated ResNet8 on the (h, w) sample, zero-padded by 31 a side;
    every conv is VALID, so each shrinks the map by its dilated reach."""
    u0, u1, u2 = model["detector_units"]
    cin = model["in_channels"]
    hh, ww = h + 62, w + 62
    total = 0

    def conv(ci, co, k, d=1):
        nonlocal hh, ww, total
        hh, ww = hh - d * (k - 1), ww - d * (k - 1)
        total += conv_flops(ci, co, k, hh * ww)

    def resid(ci, co, d0, d1):
        nonlocal total
        conv(ci, ci, 3, d0)
        conv(ci, co, 3, d1)
        if ci != co:
            total += conv_flops(ci, co, 1, hh * ww)

    conv(cin, u0, 7)
    resid(u0, u0, 2, 4)
    resid(u0, u1, 2, 4)
    resid(u1, u1, 4, 8)
    conv(u1, u2, 3, 4)
    if (hh, ww) != (h, w):
        raise ValueError(f"ResNet8 plan ends at {hh}x{ww}, not {h}x{w}")
    return total + conv_flops(u2, 1, 1, h * w)     # the 1x1 classifier
