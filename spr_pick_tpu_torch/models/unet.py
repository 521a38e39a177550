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

Two routes run the same layers.  An inference forward in bf16 (gradients
off: `steps.eval_step`, the `Picker`, validation passes) takes the
channels-last route (`backbone_cl`, `rot4_fold_cl`, `head_cl`): every
activation is NHWC; each conv step is one cuDNN conv (VALID) on an already
padded bf16 buffer and one epilogue (`ops/conv_epilogue.py`: bias, LeakyReLU
and the hand-off, written into the consuming conv's padded buffer: the
blind-spot shift, the pool, the upsample into the decoder's concatenation,
the skip's slot of it, the rot4 fold's un-rotation), with the same two bf16
roundings as the other route; the last conv (96 -> out) adds its bias in
plain PyTorch.  Everything else, training (autograd) and float32, takes the
NCHW route of `ShiftConv` (pad, conv, bias add, LeakyReLU) unchanged.  An
inference forward adds its conv steps to counter ``conv.fused`` (the
channels-last route: one epilogue launch a step but the last conv's) or
``conv.plain``.  Each destination a producer writes in a conv's input
buffer adds to ``fold.direct`` (`ops/conv_epilogue.py` counts it at the
launch); each conv input a copy pass of its own writes adds to
``fold.staged`` (the NCHW route's pads, the two-lane fold's un-rotation).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spr_pick_tpu_torch.models.blindspot import (
    KAIMING_LINEAR,
    ShiftConv,
    _slope_in,
    leaky_relu,
    max_pool_2x2,
    rot4_stack,
    rot4_unstack,
    shift_down,
    upsample_nearest_2x,
)
from spr_pick_tpu_torch.ops.conv_epilogue import (
    NO_PAD,
    Pad,
    Slot,
    conv_epilogue,
    fold_input,
)
from spr_pick_tpu_torch.utils import profiling

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
        self.head_steps = 3
        self.backbone_steps = sum(
            isinstance(m, ShiftConv) for m in self.children()
        ) - self.head_steps
        # The pad of a 3x3 conv's input, (top, bottom, left, right).
        self.pad3 = (2, 0, 1, 1) if blindspot else (1, 1, 1, 1)

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
        fused = self.fused_route()
        if fused:
            h = self.rot4_fold_cl(x) if self.blindspot else self.backbone_cl(x)
            out = self.head_cl(h)
        else:
            xc = x.permute(0, 3, 1, 2)
            h = self.rot4_fold(xc) if self.blindspot else self.backbone(xc)
            out = self.head(h).permute(0, 2, 3, 1)
        self.count_steps(fused, 1)
        return out

    # ------------------------------------------------------------------
    # The channels-last route
    # ------------------------------------------------------------------

    def fused_route(self) -> bool:
        """Whether this forward takes the channels-last route: gradients
        off and the compute dtype bf16.  Training keeps the NCHW route,
        whose backward autograd derives."""
        return self.dtype == torch.bfloat16 and not torch.is_grad_enabled()

    def count_steps(self, fused: bool, backbones: int) -> None:
        """Counters ``conv.fused`` and ``conv.plain`` of an inference
        forward that ran the backbone ``backbones`` times and the head
        once; on the NCHW route each step's input is `F.pad`'s copy, one
        ``fold.staged`` each.  A forward with gradients counts nothing."""
        if torch.is_grad_enabled():
            return
        steps = backbones * self.backbone_steps + self.head_steps
        profiling.count("conv.fused", steps if fused else 0)
        profiling.count("conv.plain", 0 if fused else steps)
        if not fused:
            profiling.count("fold.staged", steps)

    def _conv_cl(self, name: str, xp: torch.Tensor) -> torch.Tensor:
        """Conv ``name`` (VALID, bf16, no bias) of the padded NHWC buffer
        ``xp``: cuDNN reads and writes channels-last, NHWC out."""
        w = getattr(self, name).conv.weight
        if w.shape[1] < xp.shape[3]:
            # Zero input channels (`fold_input`'s), zero weights.
            w = F.pad(w, (0, 0, 0, 0, 0, xp.shape[3] - w.shape[1]))
        # The cast and the re-layout in one copy.
        w = w.to(torch.bfloat16, memory_format=torch.channels_last)
        return F.conv2d(xp.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)

    def _step_cl(self, name: str, xp: torch.Tensor, pad: Pad,
                 **handoff) -> torch.Tensor:
        """One conv step: `_conv_cl`, then the epilogue, which writes the
        input of the step that consumes it, padded by ``pad`` (the epilogue
        rounds the float32 bias to bf16 itself); ``handoff``: the
        epilogue's hand-off, shift and destinations (`conv_epilogue`)."""
        return conv_epilogue(self._conv_cl(name, xp),
                             getattr(self, name).conv.bias, pad,
                             _slope_in(0.1, torch.bfloat16), **handoff)

    def _backbone_cl(self, x: torch.Tensor, rot4: bool) -> torch.Tensor:
        """`backbone` on the channels-last route, every hand-off written by
        its producer into the consuming conv's padded buffer: the input
        launch (rot4: the four rotations as lanes) into enc1_conv0's and
        dec_final_conv0's; each pool (after the blind-spot shift) into the
        next encoder conv's and its skip's slot of the decoder stage's
        concatenation; each upsample into the next stage's concatenation;
        the last step's shifted output as it is, or (rot4) un-rotated into
        the head's (B, H, W, 4 * 96) input."""
        p3, enc, dec, levels = (self.pad3, ENC_FEATURES, DEC_FEATURES,
                                self.levels)
        n, height, width, cin = x.shape
        lanes = 4 * n if rot4 else n

        def buffer(pools: int, channels: int) -> torch.Tensor:
            """A 3x3 conv's padded input buffer, ``pools`` pools down."""
            return torch.empty(
                (lanes, (height >> pools) + p3[0] + p3[1],
                 (width >> pools) + p3[2] + p3[3], channels),
                dtype=torch.bfloat16, device=x.device)

        # Decoder stage s reads [upsample, skip] at levels - 1 - s pools;
        # dec_final_conv0 reads [upsample, x].  Widths a tensor-core conv
        # of cuDNN reads without a pass of its own (measured on the H100 at
        # 1024^2): one input channel is carried as 8 (zeros), 96 + 1 as 128;
        # the weights get zeros too.
        cats = [buffer(levels - 1 - s, (enc if s == 0 else dec) + enc)
                for s in range(levels - 1)]
        cats.append(buffer(0, -(-(dec + cin) // 32) * 32))
        h = fold_input(x, p3, -(-cin // 8) * 8, Slot(cats[-1], p3, dec),
                       rot4)
        h = self._step_cl("enc1_conv0", h, p3)
        for i in range(1, levels + 1):
            s = levels - 1 - i  # the decoder stage that reads this skip
            skip = (Slot(cats[s], p3, enc if s == 0 else dec) if s >= 0
                    else None)
            h = self._step_cl("enc1_conv1" if i == 1 else f"enc{i}_conv0", h,
                              p3, handoff="pool", shift=self.blindspot,
                              skip=skip)
        self._step_cl("enc_bottom_conv0", h, p3, handoff="upsample",
                      out=cats[0])
        for s in range(levels - 1):
            h = self._step_cl(f"dec{s}_conv0", cats[s], p3)
            self._step_cl(f"dec{s}_conv1", h, p3, handoff="upsample",
                          out=cats[s + 1])
        h = self._step_cl("dec_final_conv0", cats[-1], p3)
        return self._step_cl("dec_final_conv1", h, NO_PAD,
                             handoff="unrotate" if rot4 else "copy",
                             shift=self.blindspot)

    def backbone_cl(self, x: torch.Tensor) -> torch.Tensor:
        """`backbone` on the channels-last route: NHWC lanes (any float
        dtype) in, NHWC bf16 out."""
        return self._backbone_cl(x, rot4=False)

    def rot4_fold_cl(self, x: torch.Tensor) -> torch.Tensor:
        """`rot4_fold` on the channels-last route: NHWC (B, H, W, in) in,
        (B, H, W, 4 * 96) bf16 out."""
        return self._backbone_cl(x, rot4=True)

    def head_cl(self, h: torch.Tensor) -> torch.Tensor:
        """`head` on the channels-last route: NHWC in, NHWC float32 out.
        The last conv (96 -> out) adds its bf16 bias in plain PyTorch, as
        `conv2d` does: a pass over out channels only."""
        h = self._step_cl("out_block_conv0", h, NO_PAD)
        h = self._step_cl("out_block_conv1", h, NO_PAD)
        bias = self.out_conv.conv.bias.to(torch.bfloat16)
        return (self._conv_cl("out_conv", h) + bias).float()
