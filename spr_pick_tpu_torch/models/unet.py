"""Laine-style blind-spot U-Net (the `DualNetwork` family).

PyTorch port of `spr_pick_tpu/models/unet.py` (parity:
`spr_pick/models/joint_network_v2.py:11-286`, DualNetwork, 5 levels, and
`joint_network_v2_shallow.py`, 3 levels).  ``levels`` selects the pooling
depth and ``blindspot`` toggles the shifted-conv / rot4 machinery.

Topology:
  encode_1: conv(in->48) conv(48->48) pool        (two convs only in block 1)
  encode_i: conv(48->48) pool          for i in 2..levels
  encode_bottom: conv(48->48)
  decode: upsample, then per skip (pool_{levels-1} .. pool_1):
      concat -> conv(->96) conv(96->96) -> upsample
      (first decode stage input is 48+48=96, later stages 96+48=144)
  final: concat(input) -> conv(96+in->96) conv(96->96)
  blindspot head: shift-down-1, un-rotate concat (4C=384),
      1x1 conv 384->384, 1x1 conv 384->96, 1x1 conv 96->out
  plain head: 1x1 conv 96->96, 1x1 conv 96->96, 1x1 conv 96->out

The module is split into `backbone` (enc1 .. dec_final and the final
shift-down, on a stack of already-rotated lanes) and `head` (the 1x1
chain), so the dense folds of `ops/dense_unet.py` reuse the same layers.
Submodule names follow the flax parameter tree, so ``state_dict`` keys are
the flax paths (`weights.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from spr_pick_tpu_torch.models.blindspot import (
    KAIMING_LINEAR,
    ShiftConv,
    leaky_relu,
    max_pool_2x2,
    rot4_stack,
    rot4_unstack,
    shift_down,
    upsample_nearest_2x,
)

ENC_FEATURES = 48  # encoder width, every level
DEC_FEATURES = 96  # decoder width, every stage


class BlindspotUNet(nn.Module):
    """Blind-spot (or plain) U-Net backbone with 1x1-conv output head."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 blindspot: bool = False, levels: int = 5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.blindspot = blindspot
        self.levels = levels
        self.dtype = dtype
        enc, dec = ENC_FEATURES, DEC_FEATURES

        def conv(name, nin, nout, k=3, **kw):
            self.add_module(
                name, ShiftConv(nin, nout, k, blindspot=blindspot,
                                dtype=dtype, **kw)
            )

        conv("enc1_conv0", in_channels, enc)
        conv("enc1_conv1", enc, enc)
        for i in range(2, levels + 1):
            conv(f"enc{i}_conv0", enc, enc)
        conv("enc_bottom_conv0", enc, enc)
        for stage in range(levels - 1):
            conv(f"dec{stage}_conv0", (enc if stage == 0 else dec) + enc, dec)
            conv(f"dec{stage}_conv1", dec, dec)
        conv("dec_final_conv0", dec + in_channels, dec)
        conv("dec_final_conv1", dec, dec)
        nin = 4 * dec if blindspot else dec
        conv("out_block_conv0", nin, nin, 1)
        conv("out_block_conv1", nin, dec, 1)
        conv("out_conv", dec, out_channels, 1, init_scale=KAIMING_LINEAR)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: kaiming-normal convs (linear for out_conv),
        zero biases — the flax initialisers' distributions."""
        for m in self.modules():
            if isinstance(m, ShiftConv):
                m.reset_parameters(generator)

    def _conv(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return leaky_relu(getattr(self, name)(h))

    def _pool(self, h: torch.Tensor) -> torch.Tensor:
        if self.blindspot:
            h = shift_down(h, 1, h_dim=2)
        return max_pool_2x2(h)

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        """enc1 .. dec_final (+ the final shift-down in blind-spot mode) on
        an NCHW stack of lanes.  Lanes are independent batch entries, so
        the rot4 fold and the rectangular two-lane fold share it."""
        skips = []
        h = self._conv("enc1_conv0", x)
        h = self._conv("enc1_conv1", h)
        h = self._pool(h)
        skips.append(h)
        for i in range(2, self.levels + 1):
            h = self._pool(self._conv(f"enc{i}_conv0", h))
            skips.append(h)
        h = self._conv("enc_bottom_conv0", h)

        h = upsample_nearest_2x(h)
        for stage, skip in enumerate(reversed(skips[:-1])):
            h = torch.cat([h, skip], dim=1)
            h = self._conv(f"dec{stage}_conv0", h)
            h = self._conv(f"dec{stage}_conv1", h)
            h = upsample_nearest_2x(h)
        h = torch.cat([h, x.to(h.dtype)], dim=1)
        h = self._conv("dec_final_conv0", h)
        h = self._conv("dec_final_conv1", h)
        if self.blindspot:
            h = shift_down(h, 1, h_dim=2)
        return h

    def rot4_fold(self, x: torch.Tensor) -> torch.Tensor:
        """The square blind-spot fold on NCHW: the four rotations as one
        batch through the backbone, un-rotated and channel-concatenated
        (B, 4 * 96, H, W), ready for the head."""
        return rot4_unstack(self.backbone(rot4_stack(x, 2, 3)), 2, 3, c_dim=1)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The 1x1 chain (NCHW); heads feed the NLL math, so float32 out."""
        h = self._conv("out_block_conv0", h)
        h = self._conv("out_block_conv1", h)
        return self.out_conv(h).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, in) -> (B, H, W, out) float32."""
        x = x.permute(0, 3, 1, 2)
        if self.blindspot:
            h = self.rot4_fold(x)
        else:
            h = self.backbone(x)
        return self.head(h).permute(0, 2, 3, 1)
