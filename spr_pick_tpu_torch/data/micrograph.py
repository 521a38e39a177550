"""Micrograph dataset, pad-to-multiple and unpad, and the training data
planes.

The PyTorch port of `spr_pick_tpu/data/micrograph.py` (parity:
`spr_pick/datasets/micrograph.py` and
`spr_pick/datasets/image_wrapper.py:221-276`): manifest/dir loading,
coordinate matching, mask/heatmap construction, whole-image test items and
training crops, without pandas; and the two data planes of joint training.

`DevicePatchPipeline` keeps the micrograph stack on the device (placed on
first use, or sharded over the ranks of a mesh by `shard_over`) and cuts
each batch's crops there with one gather indexed by the sampler's decoded
(image, y, x) and a flip bit a crop: the host ships four (B,) index arrays
and the (B,) labels a step.  Labels are point-reads of the host heatmaps
at the sampled centre, whatever the flip (as the reference's
micrograph.py:77 reads them).  `HostPatchPipeline` cuts the
crops on the host (zero-padded at the borders) when the stack exceeds the
device budget.  Both draw their flips from their own
``RandomState(0)``, whose state is resumable.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spr_pick_tpu_torch.data import files as file_utils
from spr_pick_tpu_torch.data import table as tbl
from spr_pick_tpu_torch.data.loader import IMAGE_EXTS, load_images_from_list
from spr_pick_tpu_torch.data.sampler import unpack_index
from spr_pick_tpu_torch.ops.heatmap import as_gaussian, as_mask
from spr_pick_tpu_torch.parallel.mesh import Mesh, owned_crops, shard_stack


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
    ph, pw = padded_shape((h, w), multiple, square)
    if ph == h and pw == w:
        return img, (h, w)
    return _reflect_pad_trailing(img, ph - h, pw - w), (h, w)


def padded_shape(shape, multiple: int, square: bool = False
                 ) -> Tuple[int, int]:
    """The (H, W) that `pad_to_multiple` pads a micrograph of ``shape`` to."""
    ph, pw = (-(-n // multiple) * multiple for n in shape[:2])
    if square:
        ph = pw = max(ph, pw)
    return ph, pw


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
    """Micrographs + particle coordinates -> masks, heatmaps, whole-image
    test items and ``crop``-px training crops.

    Parity: micrograph.py:26-299.  Images are float32 numpy in [0, 1] (MRC
    min-max-quantised, see data/loader.py), held as nested lists indexed
    [source group][image].
    """

    def __init__(self, image_path: str, coordinate_path: Optional[str],
                 radius: int = 3, gt_path: Optional[str] = None, bb: int = 32,
                 verbose: bool = True, crop: int = 72):
        self.image_path = image_path
        self.coordinate_path = coordinate_path
        self.radius = radius
        self.crop = crop
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

    def train_item(self, packed_index: int):
        """Packed index -> (centred crop, centre label, name).  Parity:
        micrograph.py:271-287 (the reference's micrograph.py:60-122)."""
        g, i, coord = (int(v) for v in unpack_index(packed_index))
        img = self.images[g][i]
        w = img.shape[1]
        x, y = coord % w, coord // w
        half = self.crop // 2
        patch = _crop_zero_pad(img, x - half, y - half, self.crop)
        label = float(self.hms[g][i].ravel()[coord])
        return patch, label, self.names[g][i]

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


def _crop_zero_pad(img: np.ndarray, x0: int, y0: int, size: int) -> np.ndarray:
    """Crop with zero fill outside bounds (PIL .crop semantics)."""
    h, w = img.shape[:2]
    out = np.zeros((size, size), dtype=img.dtype)
    sx0, sy0 = max(0, x0), max(0, y0)
    sx1, sy1 = min(w, x0 + size), min(h, y0 + size)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


class PaddedStack:
    """A list of 2-D float32 images as an (N, Hmax, Wmax) stack, each image
    zero-padded at its trailing sides; a slice of rows is built on demand,
    so a rank of a mesh builds only its own rows (`shard_stack`)."""

    def __init__(self, images):
        self.images = images
        self.shape = (len(images), max(im.shape[0] for im in images),
                      max(im.shape[1] for im in images))
        self.nbytes = int(np.prod(self.shape)) * 4

    def __getitem__(self, rows: slice) -> np.ndarray:
        picked = self.images[rows]
        out = np.zeros((len(picked),) + self.shape[1:], np.float32)
        for n, im in enumerate(picked):
            out[n, : im.shape[0], : im.shape[1]] = im
        return out


class StackOnDevice:
    """The device half of a data plane's image stack: the padded host stack
    until first use, then the whole stack on ``device`` (`images_dev`) or,
    after `shard_over`, this rank's rows of it (JAX
    `micrograph.py:405-431`, `patches.py:166-188`).  `crops` cuts a
    batch's crops from it; under a mesh each rank cuts those of the images
    it holds and the ranks sum them, so every rank gets every crop."""

    def __init__(self, stack: PaddedStack, device):
        self.device = torch.device(device)
        self.shape = stack.shape
        self._host: Optional[PaddedStack] = stack
        self._dev: Optional[torch.Tensor] = None
        self.offset = 0
        self.mesh: Optional[Mesh] = None

    @property
    def images_dev(self) -> torch.Tensor:
        """The stack (this rank's rows of it after `shard_over`) on the
        device, placed on first use."""
        if self._dev is None:
            self._place(Mesh(size=1, rank=0, device=self.device))
        return self._dev

    def shard_over(self, mesh: Mesh) -> None:
        """Place only this rank's rows, ``ceil(N / D)`` of the stack padded
        with zero images to a multiple of D, straight from the host; then
        crops are gathered from the ranks that hold them."""
        if self._dev is not None:
            raise RuntimeError("the stack is already on the device")
        self.mesh = mesh
        self._place(mesh)

    def _place(self, mesh: Mesh) -> None:
        self._dev, self.offset = shard_stack(self._host, mesh)
        self._host = None

    def crops(self, flat, ys, xs, flips, crop: int,
              centered: bool) -> torch.Tensor:
        """(B, crop, crop) crops of the global draws (`owned_crops`)."""
        out = owned_crops(self.images_dev, self.offset, flat, ys, xs, flips,
                          crop, centered)
        return out if self.mesh is None else self.mesh.global_sum(out)


class DevicePatchPipeline:
    """The training data plane with the micrograph stack on the device.

    Parity: `spr_pick_tpu/data/micrograph.py:332-513`.  All micrographs are
    stacked into one zero-padded (N, H, W) float32 array, copied to
    ``device`` on first use (`images_dev`), or sharded over the ranks of a
    mesh (`shard_over`), and each batch is one gather from it.  Raises
    ValueError when the padded stack would exceed ``max_bytes`` (the
    trainer then takes `HostPatchPipeline`).  With ``augment`` False the
    flips are all zero and nothing is drawn from the flip RandomState.
    """

    def __init__(self, dataset: MicrographDataset, crop: int,
                 augment: bool = True, max_bytes: int = 4 << 30,
                 device: torch.device | str = "cpu"):
        self.crop = crop
        self.augment = augment

        flat_images, flat_hms = [], []
        self.flat_of: Dict[Tuple[int, int], int] = {}
        for g, group in enumerate(dataset.images):
            for i, img in enumerate(group):
                self.flat_of[(g, i)] = len(flat_images)
                flat_images.append(img)
                flat_hms.append(dataset.hms[g][i])

        stack = PaddedStack(flat_images)
        if stack.nbytes > max_bytes:
            raise ValueError(
                f"micrograph stack ({stack.nbytes / 2**30:.1f} GiB padded to "
                f"{'x'.join(map(str, stack.shape))}) exceeds the device "
                f"data-plane budget ({max_bytes / 2**30:.1f} GiB)"
            )
        self.widths = np.array([im.shape[1] for im in flat_images], np.int32)
        self.heights = np.array([im.shape[0] for im in flat_images], np.int32)
        # The host heatmaps stay on the host for the label point-reads.
        self.stack = StackOnDevice(stack, device)
        self._hms_host = flat_hms
        self._np_rng = np.random.RandomState(0)

    @property
    def device(self) -> torch.device:
        return self.stack.device

    @property
    def images_dev(self) -> torch.Tensor:
        return self.stack.images_dev

    def shard_over(self, mesh: Mesh) -> None:
        """Shard the stack over the mesh's ranks (`StackOnDevice.shard_over`;
        JAX `micrograph.py:422-431`)."""
        self.stack.shard_over(mesh)

    def state_dict(self):
        """Flip-augment RNG state (resumable data plane)."""
        return {"flip_rng_state": self._np_rng.get_state()}

    def load_state_dict(self, sd) -> None:
        self._np_rng.set_state(sd["flip_rng_state"])

    def decode(self, packed_indices: np.ndarray):
        """Packed sampler indices -> (flat image idx, ys, xs) int32 arrays
        of the same shape."""
        g, i, coord = unpack_index(packed_indices)
        flat = np.array(
            [self.flat_of[(int(gg), int(ii))]
             for gg, ii in zip(g.reshape(-1), i.reshape(-1))],
            np.int32,
        ).reshape(np.shape(packed_indices))
        w = self.widths[flat]
        return flat, (coord // w).astype(np.int32), (coord % w).astype(np.int32)

    def labels_for(self, flat, ys, xs) -> np.ndarray:
        """Host point-read of the centre-pixel heatmap labels (any shape).
        Parity: the reference's micrograph.py:77, ``hm.ravel()[coord]``."""
        f = np.asarray(flat).reshape(-1)
        y = np.asarray(ys).reshape(-1)
        x = np.asarray(xs).reshape(-1)
        out = np.empty(len(f), np.float32)
        for img_idx in np.unique(f):
            m = f == img_idx
            out[m] = self._hms_host[int(img_idx)][y[m], x[m]]
        return out.reshape(np.shape(flat))

    def check_in_bounds(self, flat, ys, xs) -> None:
        """Reject centres whose crop would leave the true image: the gather
        does no zero fill (the host path's `_crop_zero_pad` does), so the
        crop would read the stack's padding or another row.  The sampler's
        margins (72 / 140) keep every draw in bounds for crops <= 144."""
        half = self.crop // 2
        rest = self.crop - half
        f = np.asarray(flat).reshape(-1)
        y = np.asarray(ys).reshape(-1)
        x = np.asarray(xs).reshape(-1)
        bad = ((y < half) | (x < half) | (y + rest > self.heights[f])
               | (x + rest > self.widths[f]))
        if bad.any():
            j = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"patch centre ({int(y[j])},{int(x[j])}) of image {int(f[j])} "
                f"(h={int(self.heights[f[j]])}, w={int(self.widths[f[j]])}) "
                f"puts the {self.crop}-px crop out of bounds. Sampler margins "
                f"must be >= crop/2."
            )

    def gather(self, flat, ys, xs, flips) -> torch.Tensor:
        """(B, crop, crop, 1) crops centred at (ys, xs) of images ``flat``,
        each mirrored along W where its flip bit is set: one gather from
        the device stack (and a sum over the ranks of a mesh)."""
        return self.stack.crops(flat, ys, xs, flips, self.crop,
                                centered=True)[..., None]

    def flips(self, shape) -> np.ndarray:
        """0/1 W-flip bits of ``shape`` from the flip RandomState: a chunk's
        (K, B) draw is the numbers of K batches' (B,) draws.  Without
        ``augment``, zeros and no draw."""
        shape = tuple(np.atleast_1d(shape))
        if not self.augment:
            return np.zeros(shape, np.int32)
        return (self._np_rng.rand(*shape) < 0.5).astype(np.int32)

    def batch(self, packed_indices: np.ndarray) -> Dict[str, torch.Tensor]:
        flat, ys, xs = self.decode(packed_indices)
        self.check_in_bounds(flat, ys, xs)
        labels = self.labels_for(flat, ys, xs)
        flips = self.flips(len(flat))
        return {"inp": self.gather(flat, ys, xs, flips),
                "target": torch.from_numpy(labels).to(self.device)}


class HostPatchPipeline:
    """Host fallback of the joint data plane: numpy crops straight from the
    dataset's arrays, so capacity is bounded by host memory like the
    reference's DataLoader path.  The trainer takes it when the device
    plane is over its budget, or under ``SPR_HOST_JOINT_DATA=1``.  Parity:
    `spr_pick_tpu/data/micrograph.py:516-552`."""

    def __init__(self, dataset: MicrographDataset, crop: int,
                 augment: bool = True, device: torch.device | str = "cpu"):
        self.dataset = dataset
        self.crop = crop
        self.augment = augment
        self.device = torch.device(device)
        self._np_rng = np.random.RandomState(0)

    def state_dict(self):
        """Flip-augment RNG state (resumable data plane)."""
        return {"flip_rng_state": self._np_rng.get_state()}

    def load_state_dict(self, sd) -> None:
        self._np_rng.set_state(sd["flip_rng_state"])

    def batch(self, packed_indices: np.ndarray) -> Dict[str, torch.Tensor]:
        packed = np.asarray(packed_indices).reshape(-1)
        b = len(packed)
        inp = np.empty((b, self.crop, self.crop, 1), np.float32)
        target = np.empty((b,), np.float32)
        flips = (self._np_rng.rand(b) < 0.5 if self.augment
                 else np.zeros(b, bool))
        for j, p in enumerate(packed):
            patch, label, _ = self.dataset.train_item(int(p))
            if flips[j]:
                patch = patch[:, ::-1]
            inp[j, :, :, 0] = patch
            target[j] = label
        return {"inp": torch.from_numpy(inp).to(self.device),
                "target": torch.from_numpy(target).to(self.device)}
