"""Counts of the `dn_ssdn` configuration: dense denoising runs the U-Net
fold alone (the ssdn posterior mean is element-wise)."""

from __future__ import annotations

from typing import Dict

from gpubench.counts import convs


def mic_flops(model: Dict, h: int, w: int) -> int:
    """Operations of one dense denoise forward of an (h, w) micrograph."""
    return convs.unet_fold_flops(model, h, w)
