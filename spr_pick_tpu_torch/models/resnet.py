"""Topaz-style ResNet6/8/16 feature extractors and the 1x1 classifier head.

PyTorch port of `spr_pick_tpu/models/resnet.py` (parity:
`spr_pick/models/feature_extractor.py`, `spr_pick/models/classifier.py`).

Every layer knows its accumulated input stride (``dense_factor``) at
construction; ``forward(x, dense=True)`` runs the same parameters as the
dilated stride-1 network (the reference's ``fill()``): the input is
zero-padded by ``width // 2`` and every conv stays VALID.

BatchNorm follows the module's ``train()``/``eval()`` mode (`batch_norm`):
the batch's statistics in train mode with flax's running update, the
running statistics in eval mode; always computed in float32 and cast back
to the compute dtype.  All tensors are NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from spr_pick_tpu_torch.models.blindspot import conv2d, torch_conv_init_
from spr_pick_tpu_torch.utils.schedule import insize_from_outsize

BN_EPS = 1e-5  # torch BatchNorm2d default, flax epsilon=1e-5
BN_DECAY = 0.9  # flax momentum (torch momentum 0.1)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    """BatchNorm in float32, output in the compute dtype.

    In eval mode it normalises with the running statistics.  In train mode
    it is flax's ``nn.BatchNorm(use_running_average=False, momentum=0.9)``
    (flax `normalization.py:_compute_stats`, `_normalize`): the batch mean
    and the biased variance E[x^2] - E[x]^2 (clipped at 0) over N, H, W,
    gradients through both, and the running update
    ``ra = 0.9 * ra + 0.1 * batch`` with that biased variance.
    ``F.batch_norm(training=True)`` would update ``running_var`` with the
    unbiased one, off by n / (n - 1): 16/15 at batch 16 on ResNet8's last
    layer, whose output is 1x1 a patch.

    A BatchNorm given a ``mesh`` attribute (`Denoiser` sets it in a
    data-parallel run, `parallel/mesh.py`) takes both moments over the
    global batch, and every rank applies the same running update.
    """
    x = x.float()
    if not bn.training:
        y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, training=False, eps=BN_EPS)
        return y.to(dtype or torch.float32)
    mean = x.mean(dim=(0, 2, 3))
    mean_sq = (x * x).mean(dim=(0, 2, 3))
    mesh = getattr(bn, "mesh", None)
    if mesh is not None:
        # Data parallel: the global batch's statistics, as GSPMD computes
        # them, with gradients through the all-reduce.
        mean, mean_sq = mesh.global_mean(torch.stack([mean, mean_sq]))
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_DECAY * bn.running_mean
                              + (1 - BN_DECAY) * mean)
        bn.running_var.copy_(BN_DECAY * bn.running_var + (1 - BN_DECAY) * var)
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    y = (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(dtype or torch.float32)


class BasicConv2d(nn.Module):
    """conv -> [bn] -> relu, VALID padding.  Parity: feature_extractor.py:279-324."""

    def __init__(self, nin: int, features: int, kernel_size: int,
                 dilation: int = 1, stride: int = 1, bn: bool = False,
                 dense_factor: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dilation = dilation
        self.stride = stride
        self.dense_factor = dense_factor
        self.dtype = dtype
        self.conv = nn.Conv2d(nin, features, kernel_size, bias=not bn)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS) if bn else None

    def forward(self, x: torch.Tensor, dense: bool = False) -> torch.Tensor:
        d = self.dilation * (self.dense_factor if dense else 1)
        s = 1 if dense else self.stride
        y = conv2d(x, self.conv, self.dtype, stride=s, dilation=d)
        if self.bn is not None:
            y = batch_norm(y, self.bn, self.dtype)
        return F.relu(y)


class MaxPoolLayer(nn.Module):
    """Dilatable max pool, VALID.  Parity: feature_extractor.py:241-277.

    It holds no parameters, so it has no place in the flax tree either.
    """

    def __init__(self, kernel_size: int, stride: int = 1,
                 dense_factor: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.dense_factor = dense_factor

    def forward(self, x: torch.Tensor, dense: bool = False) -> torch.Tensor:
        d = self.dense_factor if dense else 1
        s = 1 if dense else self.stride
        return F.max_pool2d(x, self.kernel_size, stride=s, dilation=d)


class ResidA(nn.Module):
    """Residual block: conv3 -> conv3(dilated[, strided]) + cropped skip.

    Parity: feature_extractor.py:326-415.  The skip path crops
    ``edge = d_conv0 + d_conv1`` pixels per side (the two VALID convs'
    receptive loss, dilations included), then applies a 1x1 projection (if
    nin != nout) or stride-subsampling.
    """

    def __init__(self, nin: int, nhidden: int, nout: int, dilation: int = 1,
                 stride: int = 1, bn: bool = False, dense_factor: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dilation = dilation
        self.stride = stride
        self.dense_factor = dense_factor
        self.dtype = dtype
        self.conv0 = nn.Conv2d(nin, nhidden, 3, bias=not bn)
        self.bn0 = nn.BatchNorm2d(nhidden, eps=BN_EPS) if bn else None
        self.conv1 = nn.Conv2d(nhidden, nout, 3, bias=not bn)
        self.proj = nn.Conv2d(nin, nout, 1, bias=False) if nin != nout else None
        self.bn1 = nn.BatchNorm2d(nout, eps=BN_EPS) if bn else None

    def forward(self, x: torch.Tensor, dense: bool = False) -> torch.Tensor:
        f = self.dense_factor if dense else 1
        d0, d1 = f, self.dilation * f
        s = 1 if dense else self.stride

        h = conv2d(x, self.conv0, self.dtype, dilation=d0)
        if self.bn0 is not None:
            h = batch_norm(h, self.bn0, self.dtype)
        h = F.relu(h)
        y = conv2d(h, self.conv1, self.dtype, stride=s, dilation=d1)

        edge = d0 + d1
        xc = x[:, :, edge:-edge, edge:-edge]
        if self.proj is not None:
            xc = conv2d(xc, self.proj, self.dtype, stride=s)
        elif s > 1:
            xc = xc[:, :, ::s, ::s]

        y = y + xc.to(y.dtype)
        if self.bn1 is not None:
            y = batch_norm(y, self.bn1, self.dtype)
        return F.relu(y)


class ResNet8(nn.Module):
    """Topaz ResNet8: RF width 63, total stride 4.

    Parity: feature_extractor.py:102-144 (pooling=None path: stride=2).
    ``in_channels`` is what flax infers from the input: 1 for a
    micrograph, 3 for the sample of a 3-channel denoiser.
    """

    # (kernel_size, stride) of each composite layer; a ResidA counts as one
    # layer of kernel 2 * dilation + 3 (feature_extractor.py:348).
    _META = (
        dict(kernel_size=7, stride=2),
        dict(kernel_size=7, stride=1),
        dict(kernel_size=7, stride=2),
        dict(kernel_size=7, stride=1),
        dict(kernel_size=3, stride=1),
    )
    width = insize_from_outsize(list(_META), 1)  # 63

    def __init__(self, units: Sequence[int] = (32, 64, 128), bn: bool = True,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 1):
        super().__init__()
        u = units
        self.latent_dim = u[2]
        self.layer0 = BasicConv2d(in_channels, u[0], 7, stride=2, bn=bn,
                                  dense_factor=1, dtype=dtype)
        self.layer1 = ResidA(u[0], u[0], u[0], dilation=2, bn=bn,
                             dense_factor=2, dtype=dtype)
        self.layer2 = ResidA(u[0], u[0], u[1], dilation=2, stride=2, bn=bn,
                             dense_factor=2, dtype=dtype)
        self.layer3 = ResidA(u[1], u[1], u[1], dilation=2, bn=bn,
                             dense_factor=4, dtype=dtype)
        self.layer4 = BasicConv2d(u[1], u[2], 3, bn=bn, dense_factor=4,
                                  dtype=dtype)

    def forward(self, x: torch.Tensor, dense: bool = False) -> torch.Tensor:
        if dense:
            p = self.width // 2
            x = F.pad(x, (p, p, p, p))
        for layer in (self.layer0, self.layer1, self.layer2, self.layer3,
                      self.layer4):
            x = layer(x, dense)
        return x


class ResNet6(nn.Module):
    """Topaz ResNet6: RF width 35, total stride 2, float32 (the flax module
    takes no dtype).  Parity: feature_extractor.py:65-99."""

    _META = (
        dict(kernel_size=5, stride=1),
        dict(kernel_size=3, stride=1),
        dict(kernel_size=11, stride=1),
        dict(kernel_size=3, stride=2),
        dict(kernel_size=7, stride=1),
        dict(kernel_size=3, stride=1),
    )
    width = insize_from_outsize(list(_META), 1)  # 35

    def __init__(self, units: Sequence[int] = (32, 64, 128), bn: bool = True,
                 in_channels: int = 1):
        super().__init__()
        u = units
        self.latent_dim = u[2]
        self.layer0 = BasicConv2d(in_channels, u[0], 5, bn=bn, dense_factor=1)
        self.pool0 = MaxPoolLayer(3, stride=1, dense_factor=1)
        self.layer1 = ResidA(u[0], u[0], u[1], dilation=4, bn=bn,
                             dense_factor=1)
        self.pool1 = MaxPoolLayer(3, stride=2, dense_factor=1)
        self.layer2 = ResidA(u[1], u[1], u[1], dilation=2, bn=bn,
                             dense_factor=2)
        self.layer3 = BasicConv2d(u[1], u[2], 3, bn=bn, dense_factor=2)

    def forward(self, x: torch.Tensor, dense: bool = False) -> torch.Tensor:
        if dense:
            p = self.width // 2
            x = F.pad(x, (p, p, p, p))
        for layer in (self.layer0, self.pool0, self.layer1, self.pool1,
                      self.layer2, self.layer3):
            x = layer(x, dense)
        return x


class ResNet16(nn.Module):
    """Topaz ResNet16: RF width 91, total stride 4, float32 (the flax module
    takes no dtype).  Parity: feature_extractor.py:191-238."""

    _META = (
        dict(kernel_size=7, stride=1),
        dict(kernel_size=5, stride=2),
        dict(kernel_size=5, stride=1),
        dict(kernel_size=5, stride=1),
        dict(kernel_size=5, stride=1),
        dict(kernel_size=5, stride=2),
        dict(kernel_size=5, stride=1),
        dict(kernel_size=5, stride=1),
        dict(kernel_size=5, stride=1),
    )
    width = insize_from_outsize(list(_META), 1)  # 91

    def __init__(self, units: Sequence[int] = (32, 64, 128), bn: bool = True,
                 in_channels: int = 1):
        super().__init__()
        u = units
        self.latent_dim = u[2]
        self.layer0 = BasicConv2d(in_channels, u[0], 7, bn=bn, dense_factor=1)
        self.layer1 = ResidA(u[0], u[0], u[0], stride=2, bn=bn,
                             dense_factor=1)
        self.layer2 = ResidA(u[0], u[0], u[0], bn=bn, dense_factor=2)
        self.layer3 = ResidA(u[0], u[0], u[0], bn=bn, dense_factor=2)
        self.layer4 = ResidA(u[0], u[0], u[0], bn=bn, dense_factor=2)
        self.layer5 = ResidA(u[0], u[0], u[1], stride=2, bn=bn,
                             dense_factor=2)
        self.layer6 = ResidA(u[1], u[1], u[1], bn=bn, dense_factor=4)
        self.layer7 = ResidA(u[1], u[1], u[1], bn=bn, dense_factor=4)
        self.layer8 = BasicConv2d(u[1], u[2], 5, bn=bn, dense_factor=4)

    def forward(self, x: torch.Tensor, dense: bool = False) -> torch.Tensor:
        if dense:
            p = self.width // 2
            x = F.pad(x, (p, p, p, p))
        for i in range(9):
            x = getattr(self, f"layer{i}")(x, dense)
        return x


class LinearClassifier(nn.Module):
    """1x1-conv head, float32.  Parity: classifier.py:7-38.

    Unlike the flax module, it does not own the feature extractor: the
    extractor is the caller's sibling submodule (`Detector.features`), which
    is where the flax parameter tree keeps it too.
    """

    def __init__(self, nin: int):
        super().__init__()
        self.classifier = nn.Conv2d(nin, 1, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return conv2d(z, self.classifier, None)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of a ResNet/classifier subtree: torch's default conv
    init with zero biases (the flax TORCH_CONV_DEFAULT), BatchNorm at
    identity with running stats (0, 1)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            torch_conv_init_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
