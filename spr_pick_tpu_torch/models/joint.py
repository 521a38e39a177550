"""Joint denoise + detect network.

PyTorch port of `spr_pick_tpu/models/joint.py` (parity:
`spr_pick/models/joint_network_v2.py:437-561`).  ``dense`` is a forward
argument: the same parameters give the per-crop logit (strided) or the
per-pixel map (dilated, the reference's ``fill()``, or shift-and-stitch).
Public tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spr_pick_tpu_torch.models import resnet
from spr_pick_tpu_torch.models.resnet import (
    BN_EPS,
    LinearClassifier,
    ResNet8,
    batch_norm,
)
from spr_pick_tpu_torch.models.unet import BlindspotUNet


class Detector(nn.Module):
    """BatchNorm -> ResNet8(bn=True) -> 1x1 classifier.

    Parity: joint_network_v2.py:543-561.  Returns float32 logits, NHWC.
    ``in_channels`` is the channel count of its input ``z`` (flax infers
    it): 1 for micrographs, 3 for a 3-channel denoiser's sample.

    Dense (per-pixel) mode has two implementations of the same map on the
    same parameters (`spr_pick_tpu/models/joint.py:43-90`):

    * ``dense_impl="dilated"`` (the default): the reference's ``fill()``,
      stride-1 convs dilated by the accumulated stride;
    * ``dense_impl="stitch"``: shift-and-stitch, the strided network on the
      stride^2 = 16 shifted crops of the padded input folded onto the batch,
      its outputs interleaved (depth-to-space).  It needs H and W to be
      multiples of 4; other shapes take the dilated path.
    """

    STRIDE = 4  # ResNet8's total stride

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 in_channels: int = 1, dense_impl: str = "dilated"):
        super().__init__()
        if dense_impl not in ("dilated", "stitch"):
            raise ValueError(f"unknown dense_impl {dense_impl!r}")
        self.dtype = dtype
        self.dense_impl = dense_impl
        self.input_bn = nn.BatchNorm2d(in_channels, eps=BN_EPS)
        self.features = ResNet8(bn=True, dtype=dtype, in_channels=in_channels)
        self.classifier = LinearClassifier(self.features.latent_dim)

    def forward(self, x: torch.Tensor, dense: bool = False) -> torch.Tensor:
        x = batch_norm(x.permute(0, 3, 1, 2), self.input_bn, self.dtype)
        s = self.STRIDE
        if (dense and self.dense_impl == "stitch"
                and x.shape[2] % s == 0 and x.shape[3] % s == 0):
            return self._stitch(x)
        out = self.classifier(self.features(x, dense))
        return out.float().permute(0, 2, 3, 1)

    def _stitch(self, x: torch.Tensor) -> torch.Tensor:
        """Shift-and-stitch dense map of the NCHW input -> (B, H, W, 1)."""
        b, _, h, w = x.shape
        s = self.STRIDE
        width = self.features.width  # 63
        pad = width // 2
        # The strided input edge that gives exactly h / 4 sites a shift:
        # 4 * (h / 4 - 1) + width = h + 59.
        l_h, l_w = h + width - s, w + width - s
        xp = F.pad(x, (pad, pad, pad, pad))
        stacked = torch.cat([xp[:, :, dy : dy + l_h, dx : dx + l_w]
                             for dy in range(s) for dx in range(s)])
        sub = self.classifier(self.features(stacked))  # (16B, 1, h/4, w/4)
        sub = sub.reshape(s, s, b, h // s, w // s)
        # out[b, 4i + dy, 4j + dx] = sub[dy, dx, b, i, j]
        return sub.permute(2, 3, 0, 4, 1).reshape(b, h, w, 1).float()


class JointNetwork(nn.Module):
    """Blind-spot U-Net (mu | A) -> reparameterised sample -> detector.

    ``forward`` returns ``(out_stats, detect_logits)``:
      * out_stats: B,H,W,out_channels with [..., 0:in] = mu and the rest = A
        (sigma_x = A**2), parity joint_network_v2.py:469-475,509-532;
      * detect_logits: per-crop (strided) or per-pixel (dense) logits.

    The reparameterisation noise ``eps`` is passed in, or drawn from
    ``generator`` (the reference always samples, also in eval).
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 2,
                 blindspot: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.denoise_branch = BlindspotUNet(
            in_channels=in_channels, out_channels=out_channels,
            blindspot=blindspot, levels=5, dtype=dtype,
        )
        self.detector = Detector(dtype=dtype, in_channels=in_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.denoise_branch.reset_parameters(generator)
        resnet.reset_parameters(self.detector, generator)

    def sample(self, out_stats: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z = mu + eps * A**2 from the U-Net's float32 output."""
        c = self.in_channels
        mu_x = out_stats[..., 0:c]
        # Leading in_channels of A scale the sample (the reference's
        # reparameterize assumes out_channels = 2 * in_channels).
        sigma_x = out_stats[..., c:self.out_channels][..., 0:c] ** 2
        if eps is None:
            eps = torch.randn(mu_x.shape, generator=generator,
                              device=mu_x.device, dtype=mu_x.dtype)
        return mu_x + eps * sigma_x

    def forward(self, x: torch.Tensor, dense: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        out_stats = self.denoise_branch(x)
        z = self.sample(out_stats, eps, generator)
        return out_stats, self.detector(z, dense)
