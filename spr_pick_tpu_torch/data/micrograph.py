"""Micrograph dataset (evaluation side), pad-to-multiple and unpad.

The PyTorch port's copy of `spr_pick_tpu/data/micrograph.py:36-319`
(parity: `spr_pick/datasets/micrograph.py` and
`spr_pick/datasets/image_wrapper.py:221-276`): manifest/dir loading,
coordinate matching, mask/heatmap construction and whole-image test items,
without pandas.  Training patches and the device data plane belong to a
later slice.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from spr_pick_tpu_torch.data import files as file_utils
from spr_pick_tpu_torch.data import table as tbl
from spr_pick_tpu_torch.data.loader import IMAGE_EXTS, load_images_from_list
from spr_pick_tpu_torch.ops.heatmap import as_gaussian, as_mask


def _image_table(path: str, image_ext: str = "") -> tbl.Table:
    """Manifest TSV or directory -> table(image_name, path).

    Parity: micrograph.py:217-229.  An empty directory raises instead of
    yielding a 0-image dataset.
    """
    if os.path.isdir(path):
        names, valid = [], []
        for p in glob.glob(path + os.sep + "*" + image_ext):
            name, ext = os.path.splitext(os.path.basename(p))
            if ext.lower() in IMAGE_EXTS:
                names.append(name)
                valid.append(p)
        if not valid:
            raise ValueError(
                f"no images with extensions {IMAGE_EXTS} found under {path!r}"
            )
        return {"image_name": np.array(names, dtype=object),
                "path": np.array(valid, dtype=object)}
    return tbl.read_tsv(path)


def pad_to_multiple(img: np.ndarray, multiple: int,
                    square: bool = False) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Reflection-pad H,W (trailing sides) up to a multiple.

    Parity: image_wrapper.py:221-249 (left/top 0, right/bottom padded).
    ``square=True`` additionally pads the shorter side to the longer one
    (the blind-spot rot4 fold needs H == W).  Returns
    (padded, original_shape).
    """
    h, w = img.shape[:2]
    ph = (h + multiple - 1) // multiple * multiple
    pw = (w + multiple - 1) // multiple * multiple
    if square:
        ph = pw = max(ph, pw)
    if ph == h and pw == w:
        return img, (h, w)
    return _reflect_pad_trailing(img, ph - h, pw - w), (h, w)


def _reflect_pad_trailing(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Reflection-pad the trailing H/W sides by (ph, pw).

    np.pad(mode="reflect") requires pad < dim; square-padding a
    rectangular micrograph with aspect ratio >= 2 violates that, so the
    pad is applied in passes (each bounded by dim-1).  Degenerate 1-px
    dims fall back to edge replication (reflect is undefined there).
    """
    while ph > 0 or pw > 0:
        h, w = img.shape[:2]
        if (ph > 0 and h <= 1) or (pw > 0 and w <= 1):
            pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
            return np.pad(img, pad, mode="edge")
        dh = min(ph, h - 1)
        dw = min(pw, w - 1)
        pad = [(0, dh), (0, dw)] + [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pad, mode="reflect")
        ph -= dh
        pw -= dw
    return img


def unpad(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Crop back to the original (H, W).  Parity: image_wrapper.py:251-276."""
    return img[: shape[0], : shape[1]]


class MicrographDataset:
    """Micrographs + particle coordinates -> masks, heatmaps and whole-image
    test items.

    Parity: micrograph.py:26-299.  Images are float32 numpy in [0, 1] (MRC
    min-max-quantised, see data/loader.py), held as nested lists indexed
    [source group][image].
    """

    def __init__(self, image_path: str, coordinate_path: Optional[str],
                 radius: int = 3, gt_path: Optional[str] = None, bb: int = 32,
                 verbose: bool = True):
        self.image_path = image_path
        self.coordinate_path = coordinate_path
        self.radius = radius
        self.gt_path = gt_path
        self.bb = bb
        self.verbose = verbose
        self._load()

    def _load(self):
        train_images = _image_table(self.image_path)
        gt_images = _image_table(self.gt_path) if self.gt_path else None
        if self.coordinate_path:
            targets = file_utils.read_coordinates(self.coordinate_path)
        else:
            targets = tbl.empty(("image_name", "x_coord", "y_coord"))
        # Default the source column per table (micrograph.py:248 defaults
        # only when both lack it).
        for t in (train_images, targets, gt_images):
            if t is not None and "source" not in t:
                t["source"] = np.zeros(tbl.num_rows(t), np.int64)

        images = load_images_from_list(
            train_images["image_name"], train_images["path"],
            sources=train_images["source"],
        )
        gts = None
        if gt_images is not None:
            gts = load_images_from_list(
                gt_images["image_name"], gt_images["path"],
                sources=gt_images["source"],
            )

        # Drop coordinates with no matching image (micrograph.py:260-272).
        names = {n for d in images.values() for n in d}
        targets = tbl.select(targets, np.array(
            [n in names for n in targets["image_name"]], bool))
        self._warn_on_scale(targets, images)

        # Per-image coordinates, in file order (groupby(source, name)).
        coord_map: Dict = {}
        for source, name, x, y in zip(targets["source"], targets["image_name"],
                                      targets["x_coord"], targets["y_coord"]):
            coord_map.setdefault(source, {}).setdefault(name, []).append((x, y))
        null_xy = np.zeros((0, 2), dtype=np.int32)

        self.images: List[List[np.ndarray]] = []
        self.targets: List[List[np.ndarray]] = []
        self.hms: List[List[np.ndarray]] = []
        self.gts: List[List[np.ndarray]] = []
        self.names: List[List[str]] = []
        self.coords: List[List[np.ndarray]] = []
        for source, group in images.items():
            g_imgs, g_tgts, g_hms, g_gts, g_names, g_xy = [], [], [], [], [], []
            for name, im in group.items():
                xy = coord_map.get(source, {}).get(name)
                xy = null_xy if xy is None else np.array(xy, dtype=np.int32)
                shape = im.shape[:2]
                radii = np.full(len(xy), self.radius, dtype=np.int32)
                g_imgs.append(im)
                g_tgts.append(as_mask(shape, xy[:, 0], xy[:, 1], radii))
                g_hms.append(as_gaussian(shape, xy[:, 0], xy[:, 1], bb=self.bb))
                if gts is not None:
                    g_gts.append(gts[source][name])
                g_names.append(name)
                g_xy.append(xy)
            self.images.append(g_imgs)
            self.targets.append(g_tgts)
            self.hms.append(g_hms)
            if gts is not None:
                self.gts.append(g_gts)
            self.names.append(g_names)
            self.coords.append(g_xy)

        self.num_images = sum(len(g) for g in self.images)
        # Flat index -> (group, local), so test items span every source.
        self._flat_index = [
            (g, i) for g, group in enumerate(self.images)
            for i in range(len(group))
        ]
        self.num_positive_regions, self.total_regions = self._report_stats()

    @staticmethod
    def _warn_on_scale(targets: tbl.Table, images: Dict) -> None:
        """Sanity warnings (micrograph.py:274-291)."""
        n = tbl.num_rows(targets)
        if not n:
            return
        ims = [im for d in images.values() for im in d.values()]
        width = max(im.shape[1] for im in ims)
        height = max(im.shape[0] for im in ims)
        x, y = targets["x_coord"], targets["y_coord"]
        oob = int(((x > width) | (y > height)).sum())
        if oob > int(0.1 * n):
            print(
                f"WARNING: {oob} particle coordinates are out of the "
                "micrograph dimensions. Did you scale the micrographs and "
                "particle coordinates correctly?",
                file=sys.stderr,
            )
        if x.max() < 0.7 * width and y.max() < 0.7 * height:
            print(
                "WARNING: no coordinates are observed near the right/bottom "
                "borders. Did you scale the micrographs and particle "
                "coordinates correctly?",
                file=sys.stderr,
            )

    def _report_stats(self):
        """p_observed stats print (micrograph.py:197-210)."""
        if self.verbose:
            print("source\tsplit\tp_observed\tnum_positive_regions\t"
                  "total_regions")
        num_pos = total = 0
        for i, group in enumerate(self.targets):
            p = int(sum(t.sum() for t in group))
            tot = sum(t.size for t in group)
            num_pos += p
            total += tot
            if self.verbose:
                print(f"{i}\ttrain\t{p / max(tot, 1):.3g}\t{p}\t{tot}")
        return num_pos, total

    def __len__(self):
        return self.num_images

    def test_item(self, index: int, pad_multiple: int = 32,
                  square: bool = False) -> Dict:
        """Whole padded micrograph + metadata (micrograph.py:128-164);
        ``square`` pads to a square canvas for blind-spot dense eval."""
        g, i = self._flat_index[index]
        padded, shape = pad_to_multiple(self.images[g][i], pad_multiple,
                                        square=square)
        hm_p, _ = pad_to_multiple(self.hms[g][i], pad_multiple, square=square)
        return {
            "inp": padded[None, :, :, None],
            "hm": hm_p[None, :, :, None],
            "image_shape": shape,
            "name": self.names[g][i],
            "gt": self.gts[g][i] if self.gts else None,
            "target": self.targets[g][i],
        }
