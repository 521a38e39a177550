"""The plain reference of the `joint_var` configuration (spr_pick's
``--algorithm ssdn --noise_value var``): `model.py`'s joint model (the
blind-spot U-Net's rot4 fold, the reparameterised sample, the dilated
ResNet8) beside a second network of another kind, the sigma net, whose
map, averaged over the micrograph, is the noise level of the ssdn
posterior mean.

The sigma net is upstream's `DualNetworkShallow` (`denoiser_v2.py`,
`joint_network_v2_shallow.py`): a plain U-Net of 3 levels, 48 features
in the encoder and 96 in the decoder, every 3x3 conv zero-padded by one
on each side, 2x2 max pools with no shift, nearest-neighbour upsampling,
skip concatenations as in the blind-spot U-Net, the input concatenated
before the final pair, and the 1x1 head 96 -> 96 -> 96 -> 1 (LeakyReLU
0.1 after every conv but the last).  The noise level of a micrograph is
softplus(mean over H and W of the map - 4) + 1e-3, and the posterior mean
(y sigma_x + mu sigma_n) / (sigma_x + sigma_n) with sigma_x = A^2 of the
blind-spot U-Net and sigma_n the level squared.

Plain PyTorch, float32 and TF32 off (each output below is computed
inside `model.with_tf32_off`); it imports nothing of the program under
test.  ``precision`` rounds the sigma net's convs as `model.Net` rounds
every other conv.  Departures from upstream:

- random weights from the seed; the sigma net's output bias is set in
  set-up (`calibrate_sigma`) so that the level of the pool's first
  micrograph is ``sigma_level_raw`` (upstream learns it);
- evaluation only: the sigma net runs once on the whole (decoded)
  micrograph, its mean taken over every pixel, as dense evaluation does;
- no learnt constant ``estimated_sigma``: the var model has none.

Parameter names: `model.py`'s, without ``estimated_sigma``, and the
sigma net's under ``sigma.`` followed by its layer names (those of the
program's sigma net).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import model as ref

SIGMA = "sigma."   # prefix of the sigma net's parameters


def sigma_layers(model: Dict) -> "OrderedDict[str, Tuple[int, int, int, str]]":
    """name -> (in, out, kernel, init) of the sigma net's convs: the
    backbone of a ``sigma_levels``-level U-Net, then the plain head."""
    plain = dict(model, levels=model["sigma_levels"])
    out = OrderedDict((k, v) for k, v in ref.unet_layers(plain).items()
                      if not k.startswith("out_"))
    dec = model["dec_features"]
    out["out_block_conv0"] = (dec, dec, 1, "leaky")
    out["out_block_conv1"] = (dec, dec, 1, "leaky")
    out["out_conv"] = (dec, 1, 1, "linear")
    return out


def param_specs(model: Dict) -> "OrderedDict[str, Tuple[tuple, str, float]]":
    """`model.param_specs` without the learnt constant, then the sigma
    net's convs, initialised as the blind-spot U-Net's."""
    out = ref.param_specs(dict(model, estimated_sigma_raw=0.0))
    del out["estimated_sigma"]
    for name, (nin, nout, k, init) in sigma_layers(model).items():
        gain = 2.0 / (1.0 + ref.LEAKY_SLOPE ** 2) if init == "leaky" else 1.0
        out[f"{SIGMA}{name}.conv.weight"] = (
            (nout, nin, k, k), "normal", (gain / (nin * k * k)) ** 0.5)
        out[f"{SIGMA}{name}.conv.bias"] = ((nout,), "zeros", 0.0)
    return out


def make_weights(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed`` on ``device``, drawn as
    `model.make_weights` draws: one normal draw for every random leaf
    together, cut into leaves and scaled."""
    specs = param_specs(model)
    total = sum(int(np.prod(s)) for s, kind, _ in specs.values()
                if kind == "normal")
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, kind, scale) in specs.items():
        n = int(np.prod(shape))
        if kind == "normal":
            out[name] = flat[at:at + n].view(shape) * scale
            at += n
        elif name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
    return out


class Net(ref.Net):
    """`model.Net` with the sigma net, the var noise level and the var
    posterior mean."""

    def _plain_act(self, x, name, k=3, act=True):
        """SAME conv of the sigma net (zero pad k // 2 on every side), then
        LeakyReLU(0.1) unless ``act`` is False."""
        h = k // 2
        if h:
            x = F.pad(x, (h, h, h, h))
        y = self.conv(x, f"{SIGMA}{name}.conv")
        return F.leaky_relu(y, ref.LEAKY_SLOPE) if act else y

    def _sigma_map(self, x):
        """(B, 1, H, W) -> (B, 1, H, W) map of the plain U-Net."""
        levels = self.model["sigma_levels"]
        skips = []
        h = self._plain_act(self._plain_act(x, "enc1_conv0"), "enc1_conv1")
        h = F.max_pool2d(h, 2)
        skips.append(h)
        for i in range(2, levels + 1):
            h = F.max_pool2d(self._plain_act(h, f"enc{i}_conv0"), 2)
            skips.append(h)
        h = self._up(self._plain_act(h, "enc_bottom_conv0"))
        for s, skip in enumerate(reversed(skips[:-1])):
            h = torch.cat([h, skip], 1)
            h = self._plain_act(self._plain_act(h, f"dec{s}_conv0"),
                                f"dec{s}_conv1")
            h = self._up(h)
        h = torch.cat([h, x], 1)
        h = self._plain_act(self._plain_act(h, "dec_final_conv0"),
                            "dec_final_conv1")
        h = self._plain_act(h, "out_block_conv0", 1)
        h = self._plain_act(h, "out_block_conv1", 1)
        return self._plain_act(h, "out_conv", 1, act=False)

    def sigma_map(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W) decoded micrograph -> the sigma net's (H, W) map."""
        return ref.with_tf32_off(self._sigma_map, img[None, None])[0, 0]

    def noise_level(self, img: torch.Tensor) -> torch.Tensor:
        """The micrograph's noise s.d.: softplus(mean(map) - 4) + 1e-3."""
        return F.softplus(self.sigma_map(img).mean() - 4.0) + 1e-3

    def _denoised(self, img):
        stats = self.unet(img[None, None])
        mu, sx = stats[0, 0], stats[0, 1] ** 2
        sn = self.noise_level(img) ** 2
        return (img * sx + mu * sn) / (sx + sn)

    def denoised(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W) decoded micrograph -> the var posterior mean."""
        return ref.with_tf32_off(self._denoised, img)


def calibrate_sigma(weights: Dict[str, torch.Tensor], model: Dict,
                    img: torch.Tensor) -> None:
    """Set the sigma net's output bias, in place, so that the mean of its
    float32 map on the decoded micrograph ``img`` is
    ``model["sigma_level_raw"]``: the bias adds to every pixel alike."""
    key = f"{SIGMA}out_conv.conv.bias"
    weights[key] = torch.zeros_like(weights[key])
    mean = Net(weights, model, "f32").sigma_map(img).mean()
    weights[key] = (float(model["sigma_level_raw"]) - mean).reshape(1)
