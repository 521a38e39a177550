"""Unlabelled image-folder dataset.

The PyTorch port's copy of `spr_pick_tpu/data/folder.py` (parity:
`spr_pick/datasets/folder.py:23-113`): recursive case-insensitive image
discovery; images load lazily as float32 numpy arrays.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from spr_pick_tpu_torch.data.loader import load_image
from spr_pick_tpu_torch.data.mrc import HEADER_DTYPE
from spr_pick_tpu_torch.params import DatasetType

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

    def image_size(self, index: int) -> Tuple[int, int]:
        """(H, W) from the MRC header without decoding the image; other
        formats through PIL, imported here."""
        path = self.paths[index]
        if path.lower().endswith(".mrc"):
            with open(path, "rb") as f:
                header = np.frombuffer(f.read(1024), dtype=HEADER_DTYPE)[0]
            return int(header["ny"]), int(header["nx"])
        from PIL import Image

        with Image.open(path) as im:
            w, h = im.size
        return h, w


def image_dataset(dtype, path: str, channels: int):
    """The unlabelled image dataset at ``path``: a folder of images, or an
    HDF5 file (h5py imported there) (train.py:336-348, 392-404)."""
    if dtype == DatasetType.FOLDER:
        return UnlabelledImageFolderDataset(path, recursive=True,
                                            channels=channels)
    if dtype == DatasetType.HDF5:
        from spr_pick_tpu_torch.data.hdf5 import HDF5Dataset

        return HDF5Dataset(path, channels=channels)
    raise NotImplementedError("Dataset type not implemented")
