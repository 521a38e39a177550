"""Programmatic picking/denoising API — the PyTorch port of
`spr_pick_tpu/api.py`.

    from spr_pick_tpu_torch.api import Picker

    picker = Picker("final-ssdn-gauss.wt")        # or .training; on the GPU
    picks = picker.pick("mic.mrc")                # DataFrame: name/x/y/score
    den   = picker.denoise("mic.mrc")             # float32 H,W

A denoise-only checkpoint (`train start --dn_only`) denoises; its `pick`
raises "checkpoint has no detector head" and `process` returns None picks,
as in the JAX package.

Semantics match the JAX package's Picker: the same dense forward, the same
greedy NMS (K1), the same 30 px border filter and x/y column order as
`_scores.txt` (train.py:write_scores).  Checkpoints written by the JAX
package load directly (`utils/checkpoint.py`), and so do the reference's
PyTorch checkpoints (`compat.py`).

The dense inference loop is the evaluator's (`eval.py`: `groups`,
`forward`): micrographs above 2048 px after padding take halo tiling
(`parallel/tiling.py`), as in the JAX package.

A one-section MRC path without ``standardize`` is read as its raw values
and min-max quantised on the device inside that forward, a tiled frame
before its windows are cut (`data/loader.py:minmax_quantize_device`, bit
for bit the host decode); arrays, ``standardize`` and other formats are
decoded on the host (`load_image`).

The Picker runs on the GPU: ``device=None`` resolves to ``cuda`` and raises
when there is none; only an explicit ``device="cpu"`` runs on the CPU.
``pandas`` is imported only where a DataFrame is built, so `pick_arrays`,
`pick_many_table` and `process_table` run without it.
"""

from __future__ import annotations

import os
import resource
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from spr_pick_tpu_torch.data import table as tbl
from spr_pick_tpu_torch.data.loader import Raw, load_image, read_raw
from spr_pick_tpu_torch.data.micrograph import unpad
from spr_pick_tpu_torch.eval import DenoiserEvaluator
from spr_pick_tpu_torch.ops.nms import nms_to_host
from spr_pick_tpu_torch.params import ConfigValue, PipelineOutput
from spr_pick_tpu_torch.utils import profiling

ImageLike = Union[str, np.ndarray]
Picks = Tuple[np.ndarray, np.ndarray]


class Picker:
    """Load a checkpoint once, then pick/denoise micrographs.

    ``checkpoint``: `.training` (full state) or `.wt` (weights+cfg) file.
    ``nms_radius`` defaults to the checkpoint cfg's NMS value,
    ``threshold`` to the product's 0.02 heatmap floor, ``max_peaks`` to the
    cfg's, ``border`` to the evaluator's 30 px frame (pass 0 to keep edge
    picks).  ``seed`` seeds the reparameterisation noise: each forward
    draws it from a generator freshly seeded with ``seed``, so repeated
    calls give the same result.

    The dense forward is the evaluator's (``self.evaluator``: `groups`,
    `forward`).  Micrographs above its ``tile_eval_threshold`` (2048 px
    after padding) take its halo tiling (``tile_eval_size``,
    ``tile_eval_halo``, as in the JAX package), and the stitched heatmap
    goes to the NMS kernel in one call.  ``devices`` (several cards, the
    first one the Picker's device) deals such a frame's windows over
    replicas of the model on those cards; the picks are the one-card
    picks.

    ``checkpoint`` may also be a reference PyTorch `.wt`/`.training`
    (`compat.py`), loaded in ``mode``.
    """

    def __init__(self, checkpoint: str, mode: str = "joint",
                 nms_radius: Optional[int] = None, threshold: float = 0.02,
                 max_peaks: Optional[int] = None, border: int = 30,
                 seed: int = 0, device=None, devices=None):
        # The evaluator owns checkpoint loading and the dense inference
        # loop; no run dir is created unless evaluate() is called.
        with profiling.span("spr.open"):
            self.evaluator = DenoiserEvaluator(checkpoint, mode=mode,
                                               device=device, devices=devices)
        self.device = self.evaluator.device
        self.denoiser = self.evaluator.denoiser
        cfg = self.evaluator.cfg
        self.nms_radius = int(
            nms_radius if nms_radius is not None else cfg[ConfigValue.NMS]
        )
        self.threshold = float(threshold)
        self.max_peaks = int(
            max_peaks if max_peaks is not None
            else cfg.get(ConfigValue.MAX_PEAKS, 2048)
        )
        self.border = int(border)
        self.seed = int(seed)

    # ------------------------------------------------------------------

    def _forward(self, images: List[Union[np.ndarray, Raw]]) -> Dict:
        """The evaluator's forward over a group, its noise from a generator
        freshly seeded with ``seed``."""
        return self.evaluator.forward(
            images, torch.Generator(device=self.device).manual_seed(self.seed))

    @staticmethod
    def _heatmaps(outputs: Dict, shape) -> torch.Tensor:
        """(B, h, w) view of the detector maps cropped to the original
        shape, still on the device."""
        if PipelineOutput.DETECT not in outputs:
            raise ValueError(
                "checkpoint has no detector head (denoise-only model); "
                "use .denoise()"
            )
        return outputs[PipelineOutput.DETECT][:, : shape[0], : shape[1], 0]

    def _nms(self, heatmap: torch.Tensor) -> Picks:
        """K1 on one (h, w) map, what a group of one takes (`nms_to_host`:
        the batched call on a batch of one); `gpubench`'s control test
        alters picks here."""
        return nms_to_host(heatmap, self.nms_radius, threshold=self.threshold,
                           max_peaks=self.max_peaks)

    def _picks(self, images: List[ImageLike], standardize: bool,
               batch_size: int = 1) -> Iterator[Tuple[int, Picks, Tuple]]:
        """(index, (scores, coords as (x, y) in NMS order), original shape)
        of each micrograph: one forward a same-shape group, and K1 in one
        call over a group's maps."""
        groups = self.evaluator.groups(
            lambda i: self._load(images[i], standardize), len(images),
            batch_size)
        for start, group in groups:
            shape = group[0].shape
            maps = self._heatmaps(self._forward(group), shape)
            picks = ([self._nms(maps[0])] if len(group) == 1
                     else self.evaluator.picks(maps, self.nms_radius,
                                               self.threshold, self.max_peaks))
            for j, p in enumerate(picks):
                yield start + j, p, shape

    def pick_arrays(self, image: ImageLike, standardize: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
        """Pick one micrograph without pandas -> (scores, coords as (x, y)
        in NMS order, original shape): what `pick` turns into its frame."""
        with profiling.span("spr.request", micrographs=1):
            ((_, (scores, coords), shape),) = self._picks([image],
                                                          standardize)
            return scores, coords, shape

    def pick(self, image: ImageLike, name: Optional[str] = None,
             standardize: bool = False):
        """Pick one micrograph -> DataFrame(image_name, x_coord, y_coord,
        score), sorted by descending score, border-filtered — the
        evaluator's _scores.txt semantics (incl. x/y column order)."""
        return tbl.to_frame(self.pick_many_table([image], standardize,
                                                 names=[name]))

    def pick_many(self, images: Iterable[ImageLike],
                  standardize: bool = False, batch_size: int = 1,
                  names: Optional[Iterable[str]] = None):
        """Pick several micrographs; one concatenated DataFrame.

        ``batch_size`` > 1 groups consecutive SAME-SHAPE micrographs into
        one dense forward and one batched NMS launch; micrographs above the
        tiling threshold go one at a time.  ``names``: optional per-image
        output names; defaults to each path's basename.
        """
        return tbl.to_frame(self.pick_many_table(images, standardize,
                                                 batch_size, names))

    def pick_many_table(self, images: Iterable[ImageLike],
                        standardize: bool = False, batch_size: int = 1,
                        names: Optional[Iterable] = None) -> tbl.Table:
        """`pick_many` without pandas: a `data/table.py` column dict.  A
        name of None takes the path's basename."""
        images = list(images)
        if names is None:
            names = [None] * len(images)
        else:
            names = list(names)
            if len(names) != len(images):
                raise ValueError(f"{len(names)} names for {len(images)} images")
        names = [self._name_for(im) if nm is None else nm
                 for im, nm in zip(images, names)]
        with profiling.span("spr.request", micrographs=len(images)):
            return tbl.concat([
                tbl.picks(names[i], *picks, shape, self.border)
                for i, picks, shape in self._picks(images, standardize,
                                                   batch_size)])

    @staticmethod
    def _name_for(image: ImageLike) -> str:
        return (
            os.path.splitext(os.path.basename(image))[0]
            if isinstance(image, str) else "image"
        )

    def _load(self, image: ImageLike, standardize: bool
              ) -> Union[np.ndarray, Raw]:
        """A micrograph as float32 H,W: a path decoded, an array checked; a
        one-section MRC path without ``standardize`` only read (`Raw`), for
        the forward to quantise on the device.  Its span counts the
        thread's minor page faults (``minflt``)."""
        with profiling.span("spr.load") as attrs:
            faults = _minor_faults()
            img = None if standardize else read_raw(image)
            if img is None and isinstance(image, str):
                img = load_image(image, standardize=standardize)
            elif img is None:
                img = np.ascontiguousarray(image, np.float32)
                if img.ndim != 2:
                    raise ValueError(
                        f"expected a 2-D micrograph, got {img.shape}")
            attrs["minflt"] = _minor_faults() - faults
        return img

    def denoise(self, image: ImageLike,
                standardize: bool = False) -> np.ndarray:
        """Denoise one micrograph -> float32 H,W (original shape)."""
        with profiling.span("spr.request", micrographs=1):
            img = self._load(image, standardize)
            return self._denoised(self._forward([img]), img.shape)

    def process(self, image: ImageLike, name: Optional[str] = None,
                standardize: bool = False):
        """ONE dense forward -> (picks DataFrame, denoised float32 H,W);
        picks is None for a denoise-only checkpoint (no detector head)."""
        table, den = self.process_table(image, name, standardize)
        return (None if table is None else tbl.to_frame(table)), den

    def process_table(self, image: ImageLike, name: Optional[str] = None,
                      standardize: bool = False):
        """`process` without pandas -> (picks table or None, denoised
        float32 H,W)."""
        if name is None:
            name = self._name_for(image)
        with profiling.span("spr.request", micrographs=1):
            img = self._load(image, standardize)
            outputs = self._forward([img])
            den = self._denoised(outputs, img.shape)
            if PipelineOutput.DETECT not in outputs:
                return None, den
            scores, coords = self._nms(self._heatmaps(outputs, img.shape)[0])
            return tbl.picks(name, scores, coords, img.shape,
                             self.border), den

    @staticmethod
    def _denoised(outputs, shape) -> np.ndarray:
        key = (
            PipelineOutput.IMG_DENOISED
            if PipelineOutput.IMG_DENOISED in outputs
            else PipelineOutput.IMG_MU
        )
        with profiling.span("spr.fetch"):
            return unpad(outputs[key][0, :, :, 0].cpu().numpy(), shape)


def _minor_faults() -> int:
    """Minor page faults of the calling thread so far."""
    return resource.getrusage(resource.RUSAGE_THREAD).ru_minflt
