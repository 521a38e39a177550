"""Unlabelled image-folder dataset.

The PyTorch port's copy of `spr_pick_tpu/data/folder.py` (parity:
`spr_pick/datasets/folder.py:23-113`): recursive case-insensitive image
discovery; images load lazily as float32 numpy arrays.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from spr_pick_tpu_torch.data.loader import load_image

EXTENSIONS = (".mrc", ".tif", ".tiff", ".png", ".jpg", ".jpeg", ".bmp", ".ppm")


def find_images(directory: str, recursive: bool = True) -> List[str]:
    paths = []
    if recursive:
        for root, _, names in os.walk(directory):
            for name in sorted(names):
                if name.lower().endswith(EXTENSIONS):
                    paths.append(os.path.join(root, name))
    else:
        for name in sorted(os.listdir(directory)):
            if name.lower().endswith(EXTENSIONS):
                paths.append(os.path.join(directory, name))
    return paths


class UnlabelledImageFolderDataset:
    def __init__(self, directory: str, recursive: bool = True,
                 channels: int = 1, standardize: bool = False):
        self.directory = directory
        self.paths = find_images(directory, recursive=recursive)
        if not self.paths:
            raise ValueError(f"no images found in {directory}")
        self.channels = channels
        self.standardize = standardize

    def __len__(self) -> int:
        return len(self.paths)

    def name(self, index: int) -> str:
        return os.path.splitext(os.path.basename(self.paths[index]))[0]

    def __getitem__(self, index: int) -> np.ndarray:
        return load_image(self.paths[index], standardize=self.standardize)
