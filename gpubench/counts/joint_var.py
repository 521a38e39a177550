"""Counts of the `joint_var` configuration: the U-Net fold, the sample
and the dilated ResNet8 detector, the sigma net (a plain U-Net of
``sigma_levels`` levels and its 1x1 head, once on the micrograph), then
K1 on the heatmap."""

from __future__ import annotations

from typing import Dict

from gpubench.counts import convs
# K1's least time on a map, as in joint_r8 (the radius is the caller's).
from gpubench.counts.joint_r8 import k1_bound_s  # noqa: F401


def sigma_flops(model: Dict, h: int, w: int) -> int:
    """The plain U-Net's backbone at (h, w), then its head 96 -> 96 ->
    96 -> 1."""
    dec = model["dec_features"]
    px = h * w
    head = (2 * convs.conv_flops(dec, dec, 1, px)
            + convs.conv_flops(dec, 1, 1, px))
    return (convs.unet_lane_flops(dict(model, levels=model["sigma_levels"]),
                                  h, w) + head)


def mic_flops(model: Dict, h: int, w: int) -> int:
    """Operations of one dense forward of an (h, w) micrograph: picks and
    the denoised image."""
    return (convs.unet_fold_flops(model, h, w)
            + convs.resnet8_dense_flops(model, h, w)
            + sigma_flops(model, h, w))
