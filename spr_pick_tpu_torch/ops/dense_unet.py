"""Dense (whole-micrograph) forward of the blind-spot U-Net.

PyTorch port of `spr_pick_tpu/ops/dense_unet.py:dense_blindspot_unet`.
The JAX package re-expresses the U-Net as a separate lean XLA program; here
the folds run over the port's own `BlindspotUNet.backbone` / `.head`, so the
conv math exists once.  In the JAX program the shift+pool is one
reduce_window whose row 0 is clamped at >= 0 (`_pool_shifted`, :76-88):
that is exactly shift-down (zero row on top) followed by the 2x2 max pool,
which is what the backbone runs.  The final shift-down happens inside the
backbone, before the un-rotation (:182).

Square inputs take the reference's rot4 batch fold (B -> 4B), the same
`BlindspotUNet.rot4_fold` the module's own forward runs.  Rectangular
inputs (H != W) take a two-lane fold: rot0/180 as one (2B, H, W) batch and
rot90/270 as a (2B, W, H) batch, un-rotated and channel-concatenated in the
order (0, 90, 180, 270).  Both folds run on the module's route
(`BlindspotUNet.fused_route`): NHWC on the channels-last route, NCHW on
the other.  On the channels-last route the rot4 fold's backbone writes the
head's input itself, un-rotated; the two-lane fold's un-rotation and
concatenation stay PyTorch copies (one ``fold.staged``: the head's input).
"""

from __future__ import annotations

import torch

from spr_pick_tpu_torch.models.blindspot import rotate
from spr_pick_tpu_torch.models.unet import BlindspotUNet
from spr_pick_tpu_torch.utils import profiling


def dense_blindspot_unet(unet: BlindspotUNet, x: torch.Tensor,
                         force_rect: bool = False) -> torch.Tensor:
    """Equivalent of ``unet(x)`` (blind-spot mode) for dense inference on
    any H, W that are multiples of 2^levels.  ``x``: (B, H, W, C) NHWC;
    returns float32 (B, H, W, out_channels).  ``force_rect`` routes a square
    input through the two-lane fold (test hook: the folds must agree)."""
    if not unet.blindspot:
        raise ValueError("dense_blindspot_unet needs a blind-spot U-Net")
    fused = unet.fused_route()
    if fused:
        fold, backbone = unet.rot4_fold_cl, unet.backbone_cl
        head = unet.head_cl
        h_dim, w_dim, c_dim = 1, 2, 3
    else:
        x = x.permute(0, 3, 1, 2)
        fold, backbone, head = unet.rot4_fold, unet.backbone, unet.head
        h_dim, w_dim, c_dim = 2, 3, 1
    if x.shape[h_dim] == x.shape[w_dim] and not force_rect:
        cat, backbones = fold(x), 1
    else:
        lane_hw = torch.cat([x, rotate(x, 180, h_dim, w_dim)], dim=0)
        lane_wh = torch.cat(
            [rotate(x, 90, h_dim, w_dim), rotate(x, 270, h_dim, w_dim)], dim=0
        )
        c0, c180 = torch.chunk(backbone(lane_hw), 2, dim=0)
        c90, c270 = torch.chunk(backbone(lane_wh), 2, dim=0)
        cat = torch.cat(
            [c0, rotate(c90, 270, h_dim, w_dim),
             rotate(c180, 180, h_dim, w_dim), rotate(c270, 90, h_dim, w_dim)],
            dim=c_dim,
        )
        backbones = 2
        if fused:
            profiling.count("fold.staged")
    out = head(cat)
    unet.count_steps(fused, backbones)
    return out if fused else out.permute(0, 2, 3, 1)
