"""Whole-image eval access over an unlabelled dataset.

The PyTorch port's copy of `spr_pick_tpu/data/patches.py:227-258`
(`UnlabeledEvalDataset`).  The denoise patch pipelines of that module belong
to a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spr_pick_tpu_torch.data.micrograph import pad_to_multiple


class UnlabeledEvalDataset:
    """The `test_item` contract of `MicrographDataset` over a folder dataset
    without coordinates, so the evaluator's dense pass and artifact dumps
    work on unlabelled data."""

    def __init__(self, dataset, gt_dataset=None):
        self.dataset = dataset
        self.gt_dataset = gt_dataset

    def __len__(self):
        return len(self.dataset)

    def test_item(self, index: int, pad_multiple: int = 32,
                  square: bool = False) -> Dict:
        img = np.asarray(self.dataset[index], np.float32)
        padded, shape = pad_to_multiple(img, pad_multiple, square=square)
        gt = None
        if self.gt_dataset is not None:
            gt = np.asarray(self.gt_dataset[index], np.float32)
        return {
            "inp": padded[None, :, :, None],
            "hm": None,
            "hm_small": None,
            "image_shape": shape,
            "name": self.dataset.name(index),
            "gt": gt,
            "target": None,
        }
