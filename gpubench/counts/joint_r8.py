"""Counts of the `joint_r8` configuration: the U-Net fold, the sample and
the dilated ResNet8 detector, then K1 on the heatmap."""

from __future__ import annotations

from typing import Dict

from gpubench.counts import convs


def mic_flops(model: Dict, h: int, w: int) -> int:
    """Operations of one dense pick forward of an (h, w) micrograph."""
    return (convs.unet_fold_flops(model, h, w)
            + convs.resnet8_dense_flops(model, h, w))


def k1_bytes(h: int, w: int, picks: int) -> int:
    """K1's least traffic: the float32 map read once, and each pick (a
    float32 score and two int32 coordinates) and the count written once."""
    return h * w * 4 + picks * (4 + 8) + 4


def k1_ops(h: int, w: int, picks: int, radius: int) -> int:
    """One comparison a pixel, and one distance test a pixel of each
    pick's (2r + 1)^2 box."""
    return h * w + picks * (2 * radius + 1) ** 2


def k1_bound_s(h: int, w: int, picks: int, radius: int,
               peaks: Dict) -> float:
    """The least time the card could take for K1 on one map: bytes at the
    HBM rate or operations at the float32 rate, whichever is longer."""
    return max(k1_bytes(h, w, picks) / peaks["hbm_bytes_per_s"],
               k1_ops(h, w, picks, radius) / peaks["f32_flops_per_s"])
