"""Synthetic noise DSL: 'gauss{SD}[_{MAX}][_nc]', 'poisson{LAM}[_{MAX}][_nc]'.

The PyTorch port's copy of `spr_pick_tpu/data/noise.py` (parity:
`spr_pick/utils/noise.py:14-154`).  Integer parameters are divided by 255
(gauss), ranges draw a per-item parameter from U(min, max), and `_nc`
disables clipping to [0, 1].

`add_style` and its helpers are the numpy host plane, a copy that draws the
same numbers from the same `RandomState` as the JAX package's.
`add_style_torch` is the counterpart of `add_style_jax` (:85-129) for the
data plane on the device: the same distributions and float32 operations,
its draws taken from a `torch.Generator` or passed in.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch


def _parse_style(style: str):
    noise_type = re.findall(r"[a-zA-Z]+", style)[0]
    params = [p for p in style.replace(noise_type, "").split("_")]
    clip = "nc" not in params
    params = [x for x in params if x != "nc" and x != ""]
    floats = any("." in x for x in params)
    params = [float(p) if floats else int(p) for p in params]
    return noise_type, params, clip


def add_gaussian(images: np.ndarray, std_dev, mean=0.0, clip=True,
                 rng: np.random.RandomState = None):
    """Add Gaussian noise.  std_dev int -> /255; tuple -> per-item uniform."""
    rng = rng or np.random
    images = np.array(images, dtype=np.float32, copy=True)
    if isinstance(std_dev, (list, tuple)):
        if len(std_dev) == 1:
            std_dev = std_dev[0]
        else:
            lo, hi = std_dev
            if isinstance(lo, int):
                lo /= 255
            if isinstance(hi, int):
                hi /= 255
            shape = (images.shape[0],) + (1,) * (images.ndim - 1)
            std_dev = rng.uniform(lo, hi, size=shape).astype(np.float32)
    if isinstance(std_dev, int):
        std_dev = std_dev / 255
    images += rng.randn(*images.shape).astype(np.float32) * std_dev + mean
    if clip:
        np.clip(images, 0.0, 1.0, out=images)
    return images, std_dev


def add_poisson(images: np.ndarray, lam, clip=True,
                rng: np.random.RandomState = None):
    rng = rng or np.random
    images = np.array(images, dtype=np.float32, copy=True)
    if isinstance(lam, (list, tuple)):
        if len(lam) == 1:
            lam = lam[0]
        else:
            lo, hi = lam
            shape = (images.shape[0],) + (1,) * (images.ndim - 1)
            lam = rng.uniform(lo, hi, size=shape).astype(np.float32)
    images *= lam
    # The reference samples Poisson(1) noise and ADDS it
    # (utils/noise.py:102-106) rather than sampling Poisson(x*lam).
    noise = rng.poisson(1.0, size=images.shape).astype(np.float32)
    images += noise
    images /= lam
    if clip:
        np.clip(images, 0.0, 1.0, out=images)
    return images, lam


def add_style(images: np.ndarray, style: str,
              rng: np.random.RandomState = None):
    noise_type, params, clip = _parse_style(style)
    if noise_type == "gauss":
        return add_gaussian(images, params, clip=clip, rng=rng)
    elif noise_type == "poisson":
        return add_poisson(images, params, clip=clip, rng=rng)
    raise NotImplementedError("Noise type not supported")


def add_style_torch(images: torch.Tensor, style: str,
                    generator: Optional[torch.Generator] = None,
                    uniform: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None):
    """`add_style` on the device: the DSL, distributions and float32
    operations of `add_style_jax`.

    ``images``: (B, H, W).  A range style draws each item's parameter as
    ``max(lo, fma(u, hi - lo, lo))`` from ``uniform`` (B, 1, 1) in [0, 1)
    (jax.random.uniform's arithmetic); ``noise`` is the (B, H, W) standard
    normal (gauss) or Poisson(1) (poisson) draw.  A draw not given comes
    from ``generator`` on the images' device, the parameter's first.
    Returns (noisy, coeff) with coeff the (B, 1, 1) s.d. or lam.
    """
    noise_type, params, clip = _parse_style(style)
    b = images.shape[0]
    pshape = (b,) + (1,) * (images.ndim - 1)
    dev = images.device

    def param():
        vals = [v / 255 if isinstance(v, int) and noise_type == "gauss" else v
                for v in params]
        if len(vals) == 1:
            return torch.full(pshape, vals[0], dtype=torch.float32, device=dev)
        # float32 bounds as host constants: no host-to-device copy, so a
        # CUDA graph can capture the draw.
        lo, hi = (np.float32(v) for v in vals)
        u = uniform
        if u is None:
            u = torch.rand(pshape, generator=generator, device=dev)
        # XLA fuses u * (hi - lo) + lo into one FMA, one rounding of the
        # exact value.  In float64 the product is exact and the sum rounds
        # before the cast to float32, which differs from one rounding only
        # where the float64 sum lands on a float32 tie.
        scaled = (u.double() * float(hi - lo) + float(lo)).float()
        return torch.clamp(scaled, min=float(lo))

    if noise_type == "gauss":
        coeff = param()
        if noise is None:
            noise = torch.randn(images.shape, generator=generator, device=dev)
        out = images + noise * coeff
    elif noise_type == "poisson":
        coeff = param()
        if noise is None:
            noise = torch.poisson(torch.ones(images.shape, device=dev),
                                  generator=generator)
        # Reference semantics (utils/noise.py:102-106): scale, add
        # Poisson(1) noise, unscale.
        out = (images * coeff + noise) / coeff
    else:
        raise NotImplementedError("Noise type not supported")
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out, coeff
