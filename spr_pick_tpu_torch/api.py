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

Micrographs above 2048 px after padding take halo tiling
(`parallel/tiling.py`, through the evaluator), as in the JAX package.

An MRC path that takes no tiling and no ``standardize`` is read as its
raw values and min-max quantised on the device, inside the forward
(`data/loader.py:minmax_quantize_device`, bit for bit the host decode);
every other input is decoded on the host (`load_image`).

The Picker runs on the GPU: ``device=None`` resolves to ``cuda`` and raises
when there is none; only an explicit ``device="cpu"`` runs on the CPU.
``pandas`` is imported only where a DataFrame is built, so `pick_arrays`,
`pick_many_table` and `process_table` run without it.
"""

from __future__ import annotations

import os
import resource
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from spr_pick_tpu_torch.data import mrc
from spr_pick_tpu_torch.data import table as tbl
from spr_pick_tpu_torch.data.loader import (U8_STEPS, load_image,
                                           minmax_quantize_device)
from spr_pick_tpu_torch.data.micrograph import pad_to_multiple, unpad
from spr_pick_tpu_torch.eval import DenoiserEvaluator
from spr_pick_tpu_torch.ops.nms import nms_batch_to_host, nms_to_host
from spr_pick_tpu_torch.params import ConfigValue, PipelineOutput
from spr_pick_tpu_torch.steps import eval_step
from spr_pick_tpu_torch.utils import profiling

ImageLike = Union[str, np.ndarray]
Picks = Tuple[np.ndarray, np.ndarray]


class _Raw:
    """An MRC micrograph's values as float32, not yet min-max quantised:
    `Picker._forward` quantises it on the device."""
    __slots__ = ("values",)

    def __init__(self, values: np.ndarray):
        self.values = values

    @property
    def shape(self) -> Tuple[int, int]:
        return self.values.shape


class Picker:
    """Load a checkpoint once, then pick/denoise micrographs.

    ``checkpoint``: `.training` (full state) or `.wt` (weights+cfg) file.
    ``nms_radius`` defaults to the checkpoint cfg's NMS value,
    ``threshold`` to the product's 0.02 heatmap floor, ``max_peaks`` to the
    cfg's, ``border`` to the evaluator's 30 px frame (pass 0 to keep edge
    picks).  ``seed`` seeds the reparameterisation noise: each call draws
    it from one generator seeded with ``seed``, so repeated calls give the
    same result.

    Micrographs above the evaluator's ``tile_eval_threshold`` (2048 px
    after padding) take its halo tiling (``self._ev.tile_eval_size``,
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
        # The evaluator owns checkpoint loading and the tiled route; no run
        # dir is created unless evaluate() is called.
        with profiling.span("spr.open"):
            self._ev = DenoiserEvaluator(checkpoint, mode=mode, device=device,
                                         devices=devices)
        self.device = self._ev.device
        self.denoiser = self._ev.denoiser
        cfg = self._ev.cfg
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
        self._u8_steps = torch.from_numpy(U8_STEPS).to(self.device)

    # ------------------------------------------------------------------

    def _forward(self, arrs: List[Union[np.ndarray, _Raw]]):
        """One dense forward over same-shape micrographs, or halo tiling
        for one above the threshold; returns (outputs on the device,
        original shape).  On the device it returns before the forward
        ends.  `_Raw` micrographs are quantised on the device after the
        upload (the reflection pad only copies pixels, so padding first
        changes no bit)."""
        with profiling.span("spr.forward"):
            square = not self.denoiser.supports_rect_dense
            raw = [i for i, a in enumerate(arrs) if isinstance(a, _Raw)]
            padded = []
            shape = None
            for a in arrs:
                p, shape = pad_to_multiple(
                    a.values if isinstance(a, _Raw) else a, 32, square=square)
                padded.append(p)
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed)
            if self._tiled(shape):
                if len(padded) != 1:
                    raise ValueError(
                        "halo tiling takes one micrograph at a time")
                item = {"inp": padded[0][None, :, :, None],
                        "image_shape": shape}
                return self._ev._evaluate_tiled(item, generator), shape
            inp = torch.from_numpy(np.stack(padded)[..., None])
            inp = inp.to(self.device)
            # In place: the model sees the strides of the host path's input
            # (a conv may pick its algorithm, and so its rounding, by them).
            if len(raw) == len(arrs):
                inp.copy_(minmax_quantize_device(inp, self._u8_steps))
            elif raw:
                inp[raw] = minmax_quantize_device(inp[raw], self._u8_steps)
            if raw:
                profiling.count("load.device_quantise", len(raw))
            return eval_step(self.denoiser, {"inp": inp},
                             generator=generator), shape

    def _tiled(self, shape) -> bool:
        """Whether a micrograph of ``shape`` takes halo tiling: its edge
        after the pad to 32 (square or not) is above the threshold."""
        return max(-(-n // 32) * 32 for n in shape) > self._ev.tile_eval_threshold

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
        return nms_to_host(heatmap, self.nms_radius, threshold=self.threshold,
                           max_peaks=self.max_peaks)

    def _pick_loaded(self, img: np.ndarray):
        outputs, shape = self._forward([img])
        scores, coords = self._nms(self._heatmaps(outputs, shape)[0])
        return scores, coords, shape

    def pick_arrays(self, image: ImageLike, standardize: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
        """Pick one micrograph without pandas -> (scores, coords as (x, y)
        in NMS order, original shape): what `pick` turns into its frame."""
        with profiling.span("spr.request", micrographs=1):
            return self._pick_loaded(self._load(image, standardize))

    def pick(self, image: ImageLike, name: Optional[str] = None,
             standardize: bool = False):
        """Pick one micrograph -> DataFrame(image_name, x_coord, y_coord,
        score), sorted by descending score, border-filtered — the
        evaluator's _scores.txt semantics (incl. x/y column order)."""
        return tbl.to_frame(self.pick_many_table([image], standardize,
                                                 names=[name]))

    def _picks_table(self, name, scores, coords, shape) -> tbl.Table:
        """Border-filter + column mapping (train.py:write_scores:
        x = coords[:, 1])."""
        b = self.border
        x_max, y_max = shape[0] - b, shape[1] - b
        keep = (
            (coords[:, 1] > b) & (coords[:, 1] < x_max)
            & (coords[:, 0] > b) & (coords[:, 0] < y_max)
        ) if b > 0 else np.ones(len(scores), bool)
        return {
            "image_name": np.array([name] * int(keep.sum()), dtype=object),
            "x_coord": coords[keep, 1].astype(np.int64),
            "y_coord": coords[keep, 0].astype(np.int64),
            "score": scores[keep],
        }

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
            tables = []
            i = 0
            carried = None  # shape-mismatched load carried to the next group
            while i < len(images):
                first = carried if carried is not None else self._load(
                    images[i], standardize
                )
                carried = None
                group, arrs = [names[i]], [first]
                while len(group) < batch_size and i + len(group) < len(images):
                    nxt = self._load(images[i + len(group)], standardize)
                    if nxt.shape != first.shape:
                        carried = nxt  # don't decode it twice
                        break
                    group.append(names[i + len(group)])
                    arrs.append(nxt)
                tables.extend(self._pick_group(group, arrs))
                i += len(group)
            return tbl.concat(tables)

    def _pick_group(self, names, arrs):
        """One dense forward + one batched NMS over a same-shape group;
        giant micrographs take halo tiling one at a time."""
        if len(arrs) == 1 or self._tiled(arrs[0].shape):
            return [self._picks_table(nm, *self._pick_loaded(a))
                    for nm, a in zip(names, arrs)]
        outputs, shape = self._forward(arrs)
        picks = nms_batch_to_host(
            self._heatmaps(outputs, shape), self.nms_radius,
            threshold=self.threshold, max_peaks=self.max_peaks,
        )
        return [
            self._picks_table(name, scores, coords, shape)
            for name, (scores, coords) in zip(names, picks)
        ]

    @staticmethod
    def _name_for(image: ImageLike) -> str:
        return (
            os.path.splitext(os.path.basename(image))[0]
            if isinstance(image, str) else "image"
        )

    def _load(self, image: ImageLike, standardize: bool
              ) -> Union[np.ndarray, _Raw]:
        """A micrograph as float32 H,W: a path decoded, an array checked;
        an MRC path that `_forward` may quantise on the device only read
        (`_Raw`).  Its span counts the thread's minor page faults
        (``minflt``)."""
        with profiling.span("spr.load") as attrs:
            faults = _minor_faults()
            img = None if standardize else self._read_raw(image)
            if img is None and isinstance(image, str):
                img = load_image(image, standardize=standardize)
            elif img is None:
                img = np.ascontiguousarray(image, np.float32)
                if img.ndim != 2:
                    raise ValueError(
                        f"expected a 2-D micrograph, got {img.shape}")
            attrs["minflt"] = _minor_faults() - faults
        return img

    def _read_raw(self, image: ImageLike) -> Optional[_Raw]:
        """The values of ``image`` if it is the path of a one-section MRC
        whose frame takes no halo tiling (its header gives the shape),
        read with one open of the file; else None."""
        if not (isinstance(image, str)
                and os.path.splitext(image)[1].lower() == ".mrc"):
            return None
        with profiling.span("spr.load.read"), open(image, "rb") as f:
            nz, ny, nx = mrc.read_shape(f)
            if nz != 1 or self._tiled((ny, nx)):
                return None
            array, _, _ = mrc.read(f)
        return _Raw(np.asarray(array, dtype=np.float32))

    def denoise(self, image: ImageLike,
                standardize: bool = False) -> np.ndarray:
        """Denoise one micrograph -> float32 H,W (original shape)."""
        with profiling.span("spr.request", micrographs=1):
            outputs, shape = self._forward([self._load(image, standardize)])
            return self._denoised(outputs, shape)

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
            outputs, shape = self._forward([self._load(image, standardize)])
            den = self._denoised(outputs, shape)
            if PipelineOutput.DETECT not in outputs:
                return None, den
            scores, coords = self._nms(self._heatmaps(outputs, shape)[0])
            return self._picks_table(name, scores, coords, shape), den

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
