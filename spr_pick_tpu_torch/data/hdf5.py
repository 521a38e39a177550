"""HDF5 image dataset: an ``images`` array and an optional ``shapes`` one.

The PyTorch port's copy of `spr_pick_tpu/data/hdf5.py` (parity:
`spr_pick/datasets/hdf5.py:19-107`), the format `tools/dataset_tool_h5`
writes.  h5py is optional and imported when a dataset is opened; without
it opening one raises an `ImportError` that says so.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class HDF5Dataset:
    def __init__(self, path: str, channels: int = 1):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                "h5py is required for HDF5 datasets but is not installed"
            ) from e

        self.path = path
        self.channels = channels
        self._file = h5py.File(path, "r")
        self.images = self._file["images"]
        self.shapes = self._file.get("shapes")

    def __len__(self) -> int:
        return len(self.images)

    def name(self, index: int) -> str:
        return f"{index:06d}"

    def __getitem__(self, index: int) -> np.ndarray:
        img = np.asarray(self.images[index], dtype=np.float32)
        if self.shapes is not None:
            h, w = self.shapes[index][:2]
            img = img.reshape(-1)[: h * w].reshape(h, w)
        # The STORED dtype decides the scale (a near-black uint8 frame would
        # fool a value test): integer data is 8-bit and divided by 255, as
        # the reference's to_tensor does; float data is taken as [0, 1].
        if np.issubdtype(self.images.dtype, np.integer):
            img = img / 255.0
        return img

    def image_size(self, index: int) -> Tuple[int, int]:
        if self.shapes is not None:
            h, w = self.shapes[index][:2]
            return int(h), int(w)
        return self.images[index].shape[:2]

    def close(self):
        self._file.close()
