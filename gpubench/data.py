"""Synthetic micrographs from a seed, and the MRC files the program reads.

A micrograph is unit Gaussian noise with Gaussian particles (s.d.
``particle_sd`` px, peak ``particle_amp``) planted at ``particle_density``
a pixel, at least 40 px from the edges, clipped to the mix's ``clip``
range as preprocessing clips outliers; both ends of that range occur in
every micrograph, so each one decodes at the same contrast.  Each
particle is rendered in its own box of +-4 s.d., so a pool of 16 1024^2
micrographs takes well under a second.  The traffic mix gives every
number.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np


def micrograph(rng: np.random.Generator, shape: Tuple[int, int],
               mix: Dict) -> np.ndarray:
    """One float32 (H, W) micrograph."""
    h, w = shape
    img = rng.standard_normal((h, w), dtype=np.float32)
    sd = float(mix["particle_sd"])
    half = int(np.ceil(4 * sd))
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1]
    blob = (float(mix["particle_amp"])
            * np.exp(-(yy ** 2 + xx ** 2) / (2 * sd * sd))).astype(np.float32)
    n = int(round(h * w * float(mix["particle_density"])))
    lo = max(40, half)
    centres = rng.integers(lo, np.array([h, w]) - lo, size=(n, 2))
    for cy, cx in centres:
        img[cy - half:cy + half + 1, cx - half:cx + half + 1] += blob
    lo, hi = mix["clip"]
    return np.clip(img, lo, hi, out=img)


def pool(seed: int, mix: Dict) -> List[np.ndarray]:
    """The mix's pool of micrographs, all from one generator of ``seed``."""
    rng = np.random.default_rng([int(seed), 0x6d6963])
    shape = (int(mix["height"]), int(mix["width"]))
    return [micrograph(rng, shape, mix) for _ in range(int(mix["pool"]))]


def write_mrc(path: str, img: np.ndarray) -> None:
    """A float32 (mode 2) single-section MRC2014 file."""
    img = np.ascontiguousarray(img, dtype="<f4")
    h, w = img.shape
    words = np.zeros(256, dtype="<i4")
    floats = words.view("<f4")
    words[0:4] = (w, h, 1, 2)               # nx, ny, nz; mode 2: float32
    words[7:10] = (w, h, 1)                 # mx, my, mz
    floats[10:13] = (w, h, 1)               # cell lengths
    floats[13:16] = 90.0                    # cell angles
    words[16:19] = (1, 2, 3)                # mapc, mapr, maps
    floats[19:22] = (img.min(), img.max(), img.mean())
    floats[54] = img.std()                  # rms
    header = bytearray(words.tobytes())
    header[208:216] = b"MAP DD\x00\x00"      # map id, little-endian stamp
    with open(path, "wb") as f:
        f.write(header)
        f.write(img.tobytes())


def write_pool(images: List[np.ndarray], directory: str) -> List[str]:
    paths = []
    for i, img in enumerate(images):
        path = os.path.join(directory, f"mic{i:03d}.mrc")
        write_mrc(path, img)
        paths.append(path)
    return paths
