"""The plain reference of the benchmark's model: the blind-spot U-Net (5
levels, 48/96), its rot4 dense fold and 1x1 head, the reparameterised
sample, the dilated ResNet8 detector (32/64/128) with BatchNorm in eval
mode and the clamped sigmoid, the MRC decode's min-max quantisation, the
ssdn posterior mean, and greedy NMS with the pick table's border filter;
and the set-up of the detector's statistics from the seed's own network
(`calibrate`).

Plain PyTorch on NCHW tensors, written from the published description
(Laine et al.'s blind-spot network, the Topaz ResNet8, `spr_pick`'s joint
network): it imports nothing of the program under test.  ``precision`` is
"f32" (float32, TF32 off: the reference); "bf16" (every conv's input,
weight and bias rounded to bfloat16, float32 accumulation: the yardstick
of what rounding to the configuration's precision alone moves); or "fp8"
(every conv's input and weight rounded to float8 e4m3 with a per-tensor
scale, float32 accumulation: the control, one precision step below the
configuration's bf16).  `precisions` maps a configuration's
``COMPUTE_DTYPE`` to its yardstick and its control, and refuses any
precision it has none for.

Parameter names are the architecture's layer names, so one flat weight
dict feeds both this module and the program's checkpoint writer.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SIGMOID_EPS = 1e-4   # the detector's sigmoid is clamped to [eps, 1 - eps]
BN_EPS = 1e-5
LEAKY_SLOPE = 0.1
FP8_MAX = 448.0      # largest finite float8 e4m3 value


# ---------------------------------------------------------------------------
# Parameters: names, shapes and the init each takes
# ---------------------------------------------------------------------------

def unet_layers(model: Dict) -> "OrderedDict[str, Tuple[int, int, int, str]]":
    """name -> (in, out, kernel, init) of the blind-spot U-Net's convs."""
    enc, dec = model["enc_features"], model["dec_features"]
    cin, cout, levels = model["in_channels"], model["out_channels"], model["levels"]
    out = OrderedDict()
    out["enc1_conv0"] = (cin, enc, 3, "leaky")
    out["enc1_conv1"] = (enc, enc, 3, "leaky")
    for i in range(2, levels + 1):
        out[f"enc{i}_conv0"] = (enc, enc, 3, "leaky")
    out["enc_bottom_conv0"] = (enc, enc, 3, "leaky")
    for s in range(levels - 1):
        out[f"dec{s}_conv0"] = ((enc if s == 0 else dec) + enc, dec, 3, "leaky")
        out[f"dec{s}_conv1"] = (dec, dec, 3, "leaky")
    out["dec_final_conv0"] = (dec + cin, dec, 3, "leaky")
    out["dec_final_conv1"] = (dec, dec, 3, "leaky")
    out["out_block_conv0"] = (4 * dec, 4 * dec, 1, "leaky")
    out["out_block_conv1"] = (4 * dec, dec, 1, "leaky")
    out["out_conv"] = (dec, cout, 1, "linear")
    return out


def resnet8_layers(model: Dict):
    """(name, in, out, kernel) of the ResNet8 detector's convs."""
    u0, u1, u2 = model["detector_units"]
    cin = model["in_channels"]
    return [
        ("layer0.conv", cin, u0, 7), ("layer1.conv0", u0, u0, 3),
        ("layer1.conv1", u0, u0, 3), ("layer2.conv0", u0, u0, 3),
        ("layer2.conv1", u0, u1, 3), ("layer2.proj", u0, u1, 1),
        ("layer3.conv0", u1, u1, 3), ("layer3.conv1", u1, u1, 3),
        ("layer4.conv", u1, u2, 3),
    ]


_BN_OF = {"layer0.conv": "layer0.bn", "layer1.conv0": "layer1.bn0",
          "layer1.conv1": "layer1.bn1", "layer2.conv0": "layer2.bn0",
          "layer2.conv1": "layer2.bn1", "layer3.conv0": "layer3.bn0",
          "layer3.conv1": "layer3.bn1", "layer4.conv": "layer4.bn"}


def param_specs(model: Dict) -> "OrderedDict[str, Tuple[tuple, str, float]]":
    """Every parameter and buffer: name -> (shape, kind, scale).  ``kind``
    "normal" draws N(0, scale^2); "zeros" / "ones" are constants; the
    learnt noise level is "const" at ``scale``."""
    out = OrderedDict()
    for name, (nin, nout, k, init) in unet_layers(model).items():
        gain = 2.0 / (1.0 + LEAKY_SLOPE ** 2) if init == "leaky" else 1.0
        out[f"denoise_branch.{name}.conv.weight"] = (
            (nout, nin, k, k), "normal", (gain / (nin * k * k)) ** 0.5)
        out[f"denoise_branch.{name}.conv.bias"] = ((nout,), "zeros", 0.0)
    cin = model["in_channels"]
    for part, val in (("weight", "ones"), ("bias", "zeros"),
                      ("running_mean", "zeros"), ("running_var", "ones"),
                      ("num_batches_tracked", "zeros")):
        out[f"detector.input_bn.{part}"] = ((cin,) if part != "num_batches_tracked"
                                            else (), val, 0.0)
    for name, nin, nout, k in resnet8_layers(model):
        # Torch's default conv init, U(+-1/sqrt(fan_in)), has this s.d.
        out[f"detector.features.{name}.weight"] = (
            (nout, nin, k, k), "normal", (1.0 / (3.0 * nin * k * k)) ** 0.5)
        bn = _BN_OF.get(name)
        if bn:
            for part, val in (("weight", "ones"), ("bias", "zeros"),
                              ("running_mean", "zeros"),
                              ("running_var", "ones"),
                              ("num_batches_tracked", "zeros")):
                shape = (nout,) if part != "num_batches_tracked" else ()
                out[f"detector.features.{bn}.{part}"] = (shape, val, 0.0)
    u2 = model["detector_units"][2]
    out["detector.classifier.classifier.weight"] = (
        (1, u2, 1, 1), "normal", (1.0 / (3.0 * u2)) ** 0.5)
    out["detector.classifier.classifier.bias"] = ((1,), "zeros", 0.0)
    out["estimated_sigma"] = ((1, 1, 1, 1), "const",
                              float(model["estimated_sigma_raw"]))
    return out


def make_weights(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed``, on ``device``: one normal draw for
    every random leaf together, from a generator on the device, cut into
    leaves and scaled."""
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
        elif kind == "const":
            out[name] = torch.full(shape, scale, device=device)
        elif name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


ROUNDINGS = {"fp8": _fp8, "bf16": _bf16}
# A configuration's compute precision -> (the yardstick a gap is measured
# in, the control one step below).  A float32 configuration would need
# another yardstick (rounding to float32 moves nothing) and TF32 or
# bfloat16 as its control: it is refused until one is written.
PRECISIONS = {"bf16": ("bf16", "fp8")}


def precisions(config: Dict) -> Tuple[str, str]:
    """(yardstick, control) of the configuration's ``COMPUTE_DTYPE``."""
    dtype = config["cfg"].get("COMPUTE_DTYPE")
    if dtype not in PRECISIONS:
        raise ValueError(f"the reference has no yardstick and control for "
                         f"COMPUTE_DTYPE {dtype!r} (only {sorted(PRECISIONS)})")
    return PRECISIONS[dtype]


class Net:
    """The forward passes, on one weight dict, in one precision."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: Dict,
                 precision: str = "f32"):
        if precision not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.w = weights
        self.model = model
        self.precision = precision
        self.calibrating = False

    def conv(self, x, name, bias=True, dilation=1):
        w = self.w[name + ".weight"]
        b = self.w.get(name + ".bias") if bias else None
        rnd = ROUNDINGS.get(self.precision)
        if rnd is not None:
            x, w = rnd(x), rnd(w)
            b = None if b is None else rnd(b)
        return F.conv2d(x, w, b, dilation=dilation)

    # -- U-Net ------------------------------------------------------------

    def _unet_conv(self, x, name, k):
        """Conv whose receptive field lies strictly above each output row
        (pad 2*(k//2) rows on top, none below), then LeakyReLU(0.1)."""
        h = k // 2
        if h:
            x = F.pad(x, (h, h, 2 * h, 0))
        return self.conv(x, f"denoise_branch.{name}.conv")

    def _act(self, x, name, k=3):
        return F.leaky_relu(self._unet_conv(x, name, k), LEAKY_SLOPE)

    @staticmethod
    def _down(x):
        """Shift down one row (zero on top), then 2x2 max pool."""
        return F.max_pool2d(F.pad(x, (0, 0, 1, 0))[:, :, :-1], 2)

    @staticmethod
    def _up(x):
        return F.interpolate(x, scale_factor=2, mode="nearest")

    def backbone(self, x):
        levels = self.model["levels"]
        skips = []
        h = self._act(self._act(x, "enc1_conv0"), "enc1_conv1")
        h = self._down(h)
        skips.append(h)
        for i in range(2, levels + 1):
            h = self._down(self._act(h, f"enc{i}_conv0"))
            skips.append(h)
        h = self._up(self._act(h, "enc_bottom_conv0"))
        for s, skip in enumerate(reversed(skips[:-1])):
            h = torch.cat([h, skip], 1)
            h = self._act(self._act(h, f"dec{s}_conv0"), f"dec{s}_conv1")
            h = self._up(h)
        h = torch.cat([h, x], 1)
        h = self._act(self._act(h, "dec_final_conv0"), "dec_final_conv1")
        return F.pad(h, (0, 0, 1, 0))[:, :, :-1]

    def unet(self, x):
        """(B, 1, H, W) -> (B, 2, H, W): the input turned by 0, 1, 2 and 3
        quarter turns through the backbone, each turned back, concatenated
        on channels in that order, then the 1x1 head.  Each turn runs
        alone, so H and W may differ (both on the 32-px grid)."""
        h = torch.cat([torch.rot90(self.backbone(torch.rot90(x, k, (2, 3))),
                                   -k, (2, 3)) for k in range(4)], 1)
        h = self._act(h, "out_block_conv0", 1)
        h = self._act(h, "out_block_conv1", 1)
        return self._unet_conv(h, "out_conv", 1)

    # -- detector ---------------------------------------------------------

    def _bn(self, x, name):
        w = self.w
        if self.calibrating:
            w[name + ".running_mean"] = x.mean((0, 2, 3))
            w[name + ".running_var"] = x.var((0, 2, 3), unbiased=False)
        return F.batch_norm(x, w[name + ".running_mean"],
                            w[name + ".running_var"], w[name + ".weight"],
                            w[name + ".bias"], training=False, eps=BN_EPS)

    def _resid(self, x, layer, d0, d1, proj):
        p = f"detector.features.{layer}"
        h = F.relu(self._bn(self.conv(x, p + ".conv0", False, d0), p + ".bn0"))
        y = self.conv(h, p + ".conv1", False, d1)
        e = d0 + d1
        xc = x[:, :, e:-e, e:-e]
        if proj:
            xc = self.conv(xc, p + ".proj", False)
        return F.relu(self._bn(y + xc, p + ".bn1"))

    def detector_logits(self, z):
        """Per-pixel logits of ResNet8 run densely: strides turned into
        dilations, the input zero-padded by half the receptive field (31)."""
        f = "detector.features"
        x = self._bn(z, "detector.input_bn")
        x = F.pad(x, (31, 31, 31, 31))
        x = F.relu(self._bn(self.conv(x, f + ".layer0.conv", False),
                            f + ".layer0.bn"))
        x = self._resid(x, "layer1", 2, 4, False)
        x = self._resid(x, "layer2", 2, 4, True)
        x = self._resid(x, "layer3", 4, 8, False)
        x = F.relu(self._bn(self.conv(x, f + ".layer4.conv", False, 4),
                            f + ".layer4.bn"))
        # The classifier is a float32 1x1 conv in the configuration.
        w = self.w
        return F.conv2d(x, w["detector.classifier.classifier.weight"],
                        w["detector.classifier.classifier.bias"])

    # -- the cells' outputs -----------------------------------------------

    def logits(self, img: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """(H, W) decoded micrograph and (H, W) sample noise -> the
        detector's (1, 1, H, W) logits on the reparameterised sample."""
        stats = self.unet(img[None, None])
        z = stats[:, :1] + eps[None, None] * stats[:, 1:2] ** 2
        return self.detector_logits(z)

    def heatmap(self, img: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """(H, W) decoded micrograph and (H, W) sample noise -> the (H, W)
        clamped-sigmoid detection map."""
        p = torch.sigmoid(self.logits(img, eps))
        return p.clamp(SIGMOID_EPS, 1 - SIGMOID_EPS)[0, 0]

    def denoised(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W) decoded micrograph -> the ssdn posterior mean
        (y sigma_x + mu sigma_n) / (sigma_x + sigma_n), sigma_x = A^2 and
        sigma_n the square of softplus(s - 4) + 1e-3 of the learnt s."""
        stats = self.unet(img[None, None])
        mu, sx = stats[0, 0], stats[0, 1] ** 2
        sn = (F.softplus(self.w["estimated_sigma"].reshape(()) - 4.0)
              + 1e-3) ** 2
        return (img * sx + mu * sn) / (sx + sn)


def calibrate(weights: Dict[str, torch.Tensor], model: Dict,
              img: torch.Tensor, eps: torch.Tensor, radius: int,
              threshold: float) -> None:
    """Set the detector's statistics from the seed's own network, as
    training would leave them, in place: every BatchNorm's running mean
    and variance become those of its input on the decoded micrograph
    ``img`` (with its sample noise ``eps``), in float32; then the
    classifier is scaled so that its logits there have unit s.d., and
    offset so that greedy NMS of ``radius`` and ``threshold`` makes
    ``model["picks_per_mpx"]`` picks a 2^20 pixels on the map.  A random
    network's logits otherwise sit within some hundredths of 0 (the map
    then holds every local maximum: thousands of picks); a fixed offset
    would leave a number of picks that swings severalfold from seed to
    seed, and the work of a request with it."""
    net = Net(weights, model, "f32")
    net.calibrating = True
    try:
        lg = with_tf32_off(net.logits, img, eps)[0, 0]
    finally:
        net.calibrating = False
    mean, sd = lg.mean(), lg.std()
    z = (lg - mean) / sd
    h, w = z.shape
    want = max(1, round(float(model["picks_per_mpx"]) * h * w / 2 ** 20))
    lo, hi = -30.0, 10.0         # too few picks at lo, too many at hi
    for _ in range(20):
        mid = (lo + hi) / 2
        hm = torch.sigmoid(z + mid).clamp(SIGMOID_EPS, 1 - SIGMOID_EPS)
        if len(greedy_nms(hm, radius, threshold)[0]) < want:
            lo = mid
        else:
            hi = mid
    wt = weights["detector.classifier.classifier.weight"]
    b = weights["detector.classifier.classifier.bias"]
    weights["detector.classifier.classifier.weight"] = wt / sd
    weights["detector.classifier.classifier.bias"] = (b - mean) / sd + hi


def with_tf32_off(fn, *args, **kw):
    """Run ``fn`` with TF32 off for matmuls and convolutions, restoring the
    flags afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return fn(*args, **kw)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# Decode, NMS and the pick table
# ---------------------------------------------------------------------------

def decode(raw: np.ndarray) -> np.ndarray:
    """What reading a float32 MRC yields: min-max to [0, 1], times 255,
    truncated to uint8, divided by 255."""
    img = raw.astype(np.float32)
    lo, hi = float(img.min()), float(img.max())
    norm = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    return (norm * 255).astype(np.uint8).astype(np.float32) / 255.0


def decoded(raw: np.ndarray, device) -> torch.Tensor:
    """`decode` as a tensor on ``device``; the fold takes frames on the
    32-px grid (the program pads others, which this reference does not)."""
    img = decode(raw)
    if img.shape[0] % 32 or img.shape[1] % 32:
        raise ValueError(f"the reference takes micrographs on the 32-px "
                         f"grid, not {img.shape}")
    return torch.from_numpy(img).to(device)


def disk_offsets(radius: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    r = int(radius)
    yy, xx = torch.meshgrid(torch.arange(-r, r + 1, device=device),
                            torch.arange(-r, r + 1, device=device),
                            indexing="ij")
    keep = yy * yy + xx * xx <= r * r
    return yy[keep], xx[keep]


def greedy_nms(hm: torch.Tensor, radius: int, threshold: float):
    """Greedy NMS: repeatedly take the highest remaining pixel strictly
    above ``threshold`` (the higher flat index among equals) and remove
    the disk of ``radius`` around it.  Returns (scores, rows, cols)."""
    h, w = hm.shape
    work = hm.clone().float().flatten()
    work[work <= threshold] = -float("inf")
    dy, dx = disk_offsets(radius, hm.device)
    scores, rows, cols = [], [], []
    while True:
        # The last maximum of the flat map is the higher flat index.
        idx = work.numel() - 1 - int(torch.argmax(work.flip(0)))
        v = float(work[idx])
        if v == -float("inf"):
            break
        y, x = divmod(idx, w)
        scores.append(v)
        rows.append(y)
        cols.append(x)
        yy, xx = y + dy, x + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        work[yy[ok] * w + xx[ok]] = -float("inf")
    return (np.asarray(scores, np.float32), np.asarray(rows, np.int64),
            np.asarray(cols, np.int64))


def pick_table(scores, rows, cols, shape, border: int) -> Dict[str, np.ndarray]:
    """Picks strictly inside a ``border``-pixel frame, as the table gives
    them: ``x_coord`` is the row and ``y_coord`` the column (the
    `_scores.txt` convention of the published picker)."""
    keep = ((rows > border) & (rows < shape[0] - border)
            & (cols > border) & (cols < shape[1] - border))
    return {"x_coord": rows[keep], "y_coord": cols[keep],
            "score": scores[keep]}
