"""Micrograph image loading + normalisation.

The PyTorch port's copy of `spr_pick_tpu/data/loader.py` (parity:
`spr_pick/utils/loader.py:49-142` and `spr_pick/utils/image.py`).  The
normalisation is load-critical for pick parity:

  MRC:  min-max normalise to [0,1] float32, scale *255, truncate to uint8,
        later divided by 255 on the way to the model.  The uint8
        quantisation is reproduced exactly with numpy (the JAX package's
        optional C++ quantiser is bit-identical to this path) and the result
        is returned as float32 in [0,1].  `minmax_quantize_device` is the
        same decode in torch ops, bit for bit: `read_raw` leaves a
        one-section MRC `Raw`, and the evaluator's forward quantises it on
        its device.
  PNG/JPEG: `unquantize` re-expands 8-bit to [-3, 3].
  TIFF: raw values (optionally standardised).

Images are plain numpy float32 H,W arrays.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.utils import profiling

IMAGE_EXTS = (".mrc", ".tiff", ".tif", ".png", ".jpg", ".jpeg")
# u8 / 255 in float32 as numpy divides, for each u8: CUDA divides by a
# scalar as a multiply by its reciprocal, which is not IEEE division.
U8_STEPS = np.arange(256, dtype=np.uint8).astype(np.float32) / 255.0


def unquantize(x: np.ndarray, mi=-3, ma=3, dtype=np.float32) -> np.ndarray:
    x = x.astype(dtype)
    return x * (ma - mi) / 255 + mi


def minmax_quantize_u8(image: np.ndarray) -> np.ndarray:
    """cv2.NORM_MINMAX to [0,1] then *255 -> uint8 truncation.

    Parity: loader.py:57-58 (`cv2.normalize(..., alpha=0, beta=1,
    NORM_MINMAX, CV_32F)` followed by `(image*255).astype(np.uint8)`).
    """
    image = image.astype(np.float32)
    lo = float(image.min())
    hi = float(image.max())
    if hi > lo:
        norm = (image - lo) / (hi - lo)
    else:
        norm = np.zeros_like(image)
    return (norm * 255).astype(np.uint8)


def minmax_quantize_device(images: torch.Tensor,
                           steps: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """`minmax_quantize_u8(image).astype(np.float32) / 255.0` of each
    micrograph along dim 0 of a float32 tensor (B, H, W, ...), bit for bit,
    on the tensor's device and without a sync.  ``steps``: `U8_STEPS` on
    that device (made anew when None).

    numpy's ``(image - lo) / (hi - lo)`` takes ``lo`` and ``hi`` as Python
    floats, so it divides by their float64 difference rounded to float32;
    here they stay device tensors, so that ``/`` is IEEE division.
    """
    dims = tuple(range(1, images.ndim))
    lo = images.amin(dim=dims, keepdim=True)
    hi = images.amax(dim=dims, keepdim=True)
    span = (hi.double() - lo.double()).float()
    norm = torch.where(hi > lo, (images - lo) / span, 0.0)
    if steps is None:
        steps = torch.from_numpy(U8_STEPS).to(images.device)
    return steps[(norm * 255).to(torch.uint8).long()]


class Raw:
    """An MRC micrograph's values as float32, not yet min-max quantised:
    `EvaluatorBase.forward` quantises it on its device."""
    __slots__ = ("values",)

    def __init__(self, values: np.ndarray):
        self.values = values

    @property
    def shape(self) -> Tuple[int, int]:
        return self.values.shape


def read_raw(image) -> Optional[Raw]:
    """The values of ``image`` if it is the path of a one-section MRC,
    read with one open of the file (span ``spr.load.read``); else None."""
    if not (isinstance(image, str)
            and os.path.splitext(image)[1].lower() == ".mrc"):
        return None
    with profiling.span("spr.load.read"):
        array, _, _ = mrc.read(image)
    if array.ndim != 2:
        return None
    return Raw(np.asarray(array, dtype=np.float32))


def load_mrc(path: str, standardize: bool = False) -> np.ndarray:
    """MRC -> min-max-quantised image as float32 in [0, 1].

    Parity: loader.py:49-59 + the downstream `to_tensor` /255 division.
    The file's read is span ``spr.load.read``.
    """
    with profiling.span("spr.load.read"):
        array, header, _ = mrc.read(path)
    image = np.asarray(array, dtype=np.float32)
    if standardize:
        image = image - float(header["amean"])
        image /= float(header["rms"])
    return minmax_quantize_u8(image).astype(np.float32) / 255.0


def _load_pil_array(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def load_tiff(path: str, standardize: bool = False) -> np.ndarray:
    x = _load_pil_array(path).astype(np.float32)
    if standardize:
        x = (x - x.mean()) / x.std()
    return x


def load_png(path: str, standardize: bool = False) -> np.ndarray:
    x = unquantize(_load_pil_array(path))
    if standardize:
        x = (x - x.mean()) / x.std()
    return x


def load_image(path: str, standardize: bool = False) -> np.ndarray:
    """Dispatch on extension.  Returns float32 H,W (grayscale)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mrc":
        img = load_mrc(path, standardize=standardize)
    elif ext in (".png", ".jpg", ".jpeg"):
        img = load_png(path, standardize=standardize)
    else:
        img = load_tiff(path, standardize=standardize)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    return np.ascontiguousarray(img, dtype=np.float32)


def load_images_from_list(names, paths, sources=None,
                          standardize: bool = False) -> Dict:
    """{source: {name: float32 image}} (or {name: image} without sources),
    in list order (loader.py:132-142)."""
    images: Dict = {}
    if sources is None:
        for name, path in zip(names, paths):
            images[name] = load_image(path, standardize=standardize)
        return images
    for source, name, path in zip(sources, names, paths):
        images.setdefault(source, {})[name] = load_image(
            path, standardize=standardize
        )
    return images
