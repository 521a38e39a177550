"""Dense evaluation: the pass shared by the trainer's validation and the
standalone evaluator, and the evaluator itself.

The PyTorch port of `spr_pick_tpu/eval.py` (`DenoiserEvaluator`) and of
the parts of `spr_pick_tpu/train.py` that evaluation uses: the test data
(`:376-441`), the dense eval pass with same-shape groups, batched NMS and
contamination seeding (`_evaluate`, `:887-1116`), halo tiling for giant
micrographs with the weight-keyed halo calibration (`:1118-1231`), the
artifact export on a thread pool (`:849-885`, `:1245-1360`) and the run-dir
naming (`:1609-1655`).  The JAX evaluator inherits all of it from the
trainer; here it is one base, `EvaluatorBase`, of both `DenoiserEvaluator`
and the trainer (`train.py`).

A group's host half (picks, PSNR, artifact submission) runs right after
its forward.  The JAX package's ``SPR_EVAL_PIPELINE=1``, which runs it one
group late (`train.py:1075-1100`), has no counterpart: on one CUDA stream
the next forward queues ahead of the held group's copies to the host, and
on an H100 the deferred loop took 11% longer at 1024^2
(`scripts/eval_ab.py`, root PERF.md).

Artifacts go to `<runs_dir>/NNNNN-eval-<config_name>/eval_imgs/` as
``{name}_{desc}.png`` and ``{name}_scores.txt`` (the reference's TSV schema:
30 px border filter, 0.02 heatmap floor, x/y columns swapped).  Forward
outputs stay on the device; a map leaves it as 8-bit pixels.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch.data import table as tbl
from spr_pick_tpu_torch.data.loader import (U8_STEPS, Raw,
                                           minmax_quantize_device)
from spr_pick_tpu_torch.data.micrograph import (pad_to_multiple,
                                               padded_shape, unpad)
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.ops.nms import nms_batch_to_host
from spr_pick_tpu_torch.parallel.dcn import allreduce_metrics, host_shard
from spr_pick_tpu_torch.params import (ConfigValue, DatasetType, Pipeline,
                                       PipelineOutput)
from spr_pick_tpu_torch.steps import eval_step
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from spr_pick_tpu_torch.utils import profiling
from spr_pick_tpu_torch.utils.device import resolve_device
from spr_pick_tpu_torch.utils.image_io import (ScalarWriter,
                                               quantize_u8_device,
                                               save_array_image, save_u8_image)
from spr_pick_tpu_torch.utils.logging_helper import setup as setup_logging
from spr_pick_tpu_torch.utils.metrics import (Metric, MetricDict,
                                              calculate_psnr, separator)

logger = logging.getLogger("eval")

HALO_CANDIDATES = (32, 64, 96, 128, 160, 224, 320)

Picks = Tuple[np.ndarray, np.ndarray]


class EvaluatorBase:
    """The dense evaluation pass over a test set, its artifacts and the run
    dir, on ``self.denoiser``.

    A subclass sets ``cfg``, ``mode``, ``denoiser``, the eval noise stream
    ``_generator`` and ``eval_history``, and provides ``iteration`` (for
    artifact names and the run name) and ``step`` (for the weight
    fingerprint).  Run dirs are `<runs_dir>/NNNNN-<RUN_KIND>-<config_name>`.

    The dense inference loop is `groups` and `forward`, which the `Picker`
    drives as well: consecutive same-shape micrographs in groups, each
    group padded, uploaded and run in one forward.  Micrographs whose
    padded edge exceeds ``tile_eval_threshold`` px (`tiled`) go alone and
    take halo tiling: ``tile_eval_size`` px tiles with a ``tile_eval_halo``
    px halo (an int, or "auto" to measure it per weight set), one window a
    forward; a subclass that sets ``_replicas`` (denoisers on other cards)
    deals the windows of a frame round-robin over them.

    With a ``mesh`` (`parallel/mesh.py`), each rank evaluates its
    `host_shard` of the micrographs and writes their artifacts, the n/PSNR
    accumulators are summed over the ranks (train.py:900-911, 1102-1116),
    and rank 0 alone names the run dir and writes the scalars and the log.
    """

    RUN_KIND = "eval"

    def __init__(self, runs_dir: str, run_dir: Optional[str] = None,
                 device=None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(
            self.mesh.device if self.mesh is not None else device)
        self.runs_dir = runs_dir
        self._run_dir = run_dir
        # The merged metric vector of the last all-reduce over the ranks
        # (parallel/dcn.py:allreduce_metrics); dropped on every reset.
        self._eval_merge_base = None
        self._generator: Optional[torch.Generator] = None
        self.testset = None
        self.test_sampler = None
        # Halo tiling (train.py:149-165).  tile + 2 * halo stays a multiple
        # of 32 (the pad grid).
        self.tile_eval_threshold = 2048
        self.tile_eval_size = 1024
        self.tile_eval_halo = 96
        # (weight fingerprint, halo, deviation curve) of the last "auto"
        # calibration: the measured decay depends on the weight set.
        self._auto_halo = None
        self._export_pool: Optional[ThreadPoolExecutor] = None
        self._pending_exports = []
        self._writer: Optional[ScalarWriter] = None
        self._replicas = []
        self._u8_steps = torch.from_numpy(U8_STEPS).to(self.device)

    @property
    def is_main(self) -> bool:
        """Whether this process writes the run's shared files (rank 0)."""
        return self.mesh is None or self.mesh.is_main

    def _agree_run_dir(self) -> None:
        """Every rank takes rank 0's run dir name."""
        if self.mesh is not None:
            self._run_dir = self.mesh.broadcast_object(
                self.run_dir if self.mesh.is_main else None)

    # ------------------------------------------------------------------
    # Test data
    # ------------------------------------------------------------------

    def test_data(self):
        """Whole-micrograph test set and its sampler (train.py:376-419)."""
        from spr_pick_tpu_torch.data.sampler import FixedLengthSampler

        cfg = self.cfg
        dtype = cfg[ConfigValue.TEST_DATASET_TYPE]
        if dtype == DatasetType.TXT or cfg[ConfigValue.TEST_LABEL_PATH]:
            from spr_pick_tpu_torch.data.micrograph import MicrographDataset

            dataset = MicrographDataset(
                cfg[ConfigValue.TEST_DATA_PATH],
                cfg[ConfigValue.TEST_LABEL_PATH],
                radius=3,
                gt_path=cfg[ConfigValue.TEST_GT_PATH],
                bb=cfg[ConfigValue.BB],
            )
        else:
            from spr_pick_tpu_torch.data.folder import (
                UnlabelledImageFolderDataset, image_dataset)
            from spr_pick_tpu_torch.data.patches import UnlabeledEvalDataset

            base = image_dataset(dtype, cfg[ConfigValue.TEST_DATA_PATH],
                                 cfg[ConfigValue.IMAGE_CHANNELS])
            gt = None
            if cfg[ConfigValue.TEST_GT_PATH]:
                gt = UnlabelledImageFolderDataset(
                    cfg[ConfigValue.TEST_GT_PATH], recursive=True
                )
            dataset = UnlabeledEvalDataset(base, gt)
        sampler = FixedLengthSampler(
            len(dataset), num_samples=cfg_mod.test_length(cfg), shuffled=False
        )
        return dataset, sampler

    def set_test_data(self, path: str):
        self.cfg[ConfigValue.TEST_DATA_PATH] = path
        self.cfg[ConfigValue.TEST_DATASET_TYPE] = None
        cfg_mod.infer_datasets(self.cfg)

    def set_test_label(self, path: str):
        self.cfg[ConfigValue.TEST_LABEL_PATH] = path

    def set_test_gt_data(self, path: str):
        self.cfg[ConfigValue.TEST_GT_PATH] = path

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def tiled(self, shape) -> bool:
        """Whether a micrograph of ``shape`` takes halo tiling: its edge
        after the pad to 32 is above ``tile_eval_threshold``."""
        return max(padded_shape(shape, 32)) > self.tile_eval_threshold

    def groups(self, load: Callable[[int], object], n: int, batch_size: int,
               shape_of: Callable = lambda image: image.shape
               ) -> Iterator[Tuple[int, List]]:
        """(position of the first, group) of the micrographs ``load(0)`` ..
        ``load(n - 1)``: consecutive ones of one ``shape_of``, up to
        ``batch_size`` a group, and one that takes halo tiling alone.  One
        whose shape ends a group is carried into the next, so none is
        loaded twice (a folder dataset decodes from disk on every load)."""
        carried = None
        i = 0
        while i < n:
            first = carried if carried is not None else load(i)
            carried = None
            group, shape = [first], shape_of(first)
            while (len(group) < batch_size and i + len(group) < n
                   and not self.tiled(shape)):
                nxt = load(i + len(group))
                if shape_of(nxt) != shape:
                    carried = nxt
                    break
                group.append(nxt)
            yield i, group
            i += len(group)

    def forward(self, images: Sequence[Union[np.ndarray, Raw]],
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One dense forward over a group of host micrographs (float32 H,W
        of one shape after the pad to 32), or halo tiling of one that takes
        it; the outputs stay on the device, padded, and on a GPU this
        returns before the forward ends.  The micrographs are padded,
        stacked and uploaded as one (B, H, W, 1) tensor, and `Raw` ones are
        min-max quantised there (the reflection pad only copies pixels, so
        padding first changes no bit).  Sample noise is drawn from
        ``generator``.  Span ``spr.forward``."""
        with profiling.span("spr.forward"):
            square = not self.denoiser.supports_rect_dense
            shape = images[0].shape
            inp = torch.from_numpy(np.stack([
                pad_to_multiple(im.values if isinstance(im, Raw) else im, 32,
                                square=square)[0]
                for im in images])[..., None]).to(self.device)
            raw = [i for i, im in enumerate(images) if isinstance(im, Raw)]
            # In place: the model sees the strides of the host path's input
            # (a conv may pick its algorithm, and so its rounding, by them).
            if len(raw) == len(images):
                inp.copy_(minmax_quantize_device(inp, self._u8_steps))
            elif raw:
                inp[raw] = minmax_quantize_device(inp[raw], self._u8_steps)
            if raw:
                profiling.count("load.device_quantise", len(raw))
            if self.tiled(shape):
                if len(images) != 1:
                    raise ValueError(
                        "halo tiling takes one micrograph at a time")
                return self.evaluate_tiled(inp[0, :, :, 0], generator, shape)
            return eval_step(self.denoiser, {"inp": inp}, generator=generator)

    def picks(self, heatmaps: torch.Tensor, radius: int, threshold: float,
              max_peaks: int, denoised: Optional[torch.Tensor] = None
              ) -> List[Picks]:
        """K1 over a group's (B, h, w) detector maps in one call, with its
        cap retries: (scores, coords) of each map.  ``denoised``: the
        group's (B, h, w) denoised maps, whose `find_contamination` masks
        seed the suppression (numpy, so those maps come to the host)."""
        suppressed = None
        if denoised is not None:
            from spr_pick_tpu_torch.ops.algorithms import find_contamination

            suppressed = np.stack([find_contamination(d) for d in
                                   denoised.cpu().numpy()]).astype(bool)
        return nms_batch_to_host(heatmaps, radius, threshold=threshold,
                                 max_peaks=max_peaks, suppressed=suppressed)

    def _cfg_picks(self, outputs: Dict, shape) -> List[Picks]:
        """`picks` over a group's ``outputs`` cropped to ``shape``, with the
        cfg's NMS radius and cap and the 0.02 floor, seeded with the
        contamination masks when the cfg excludes contamination."""
        def crop(key):
            return outputs[key][:, : shape[0], : shape[1], 0]

        den = None
        if (self.cfg.get(ConfigValue.EXCLUDE_CONTAM, False)
                and PipelineOutput.IMG_DENOISED in outputs):
            den = crop(PipelineOutput.IMG_DENOISED)
        return self.picks(crop(PipelineOutput.DETECT),
                          int(self.cfg[ConfigValue.NMS]), 0.02,
                          int(self.cfg.get(ConfigValue.MAX_PEAKS, 2048)), den)

    def _add_psnr(self, outputs: Dict, item: Dict) -> None:
        if item["gt"] is None:
            return
        shape = item["image_shape"]
        gt = np.asarray(item["gt"])[: shape[0], : shape[1]]
        for key, name in self.img_outputs(prefix="psnr").items():
            img = unpad(outputs[key][0, :, :, 0].cpu().numpy(), shape)
            self.eval_history[name] += calculate_psnr(img[None], gt[None])

    def _evaluate(self, output_callback: Optional[Callable] = None,
                  picks_for_all: bool = False):
        """Dense eval pass (train.py:887-1116): per test micrograph run the
        dense model, accumulate PSNR when gt is present, and hand outputs to
        the artifact callback.  ``picks_for_all``: the callback exports
        picks for EVERY item, so K1 runs once a group here."""
        batch_size = max(int(self.cfg[ConfigValue.TEST_MINIBATCH_SIZE] or 1), 1)
        indices = list(iter(self.test_sampler))
        # Positions in the test order; a rank of a mesh keeps its shard.
        order = list(range(len(indices)))
        if self.mesh is not None:
            order = host_shard(order, self.mesh.rank, self.mesh.size)
        square = not self.denoiser.supports_rect_dense

        def load(k):
            # Unpadded: `forward` pads.
            return self.testset.test_item(indices[order[k]], pad_multiple=1)

        def padded(item):
            return padded_shape(item["image_shape"], 32, square)

        for start, group in self.groups(load, len(order), batch_size, padded):
            outputs = self.forward([it["inp"][0, :, :, 0] for it in group],
                                   self._generator)
            shape = group[0]["image_shape"]
            group_picks = None
            if (picks_for_all and PipelineOutput.DETECT in outputs
                    and all(it["image_shape"] == shape for it in group)):
                group_picks = self._cfg_picks(outputs, shape)
            for j, item in enumerate(group):
                per = {k: v[j : j + 1] for k, v in outputs.items()
                       if v.ndim == 4}
                if group_picks is not None:
                    per["_picks"] = group_picks[j]
                self.eval_history["n"] += 1
                self._add_psnr(per, item)
                if output_callback:
                    output_callback(order[start + j], per, item)
        # Every artifact is on disk when this returns.
        self._flush_exports()
        if self.mesh is not None:
            # The logged n/PSNR are the GLOBAL ones; the key list comes
            # from the cfg, the same on every rank.
            keys = ["n"] + list(self.img_outputs(prefix="psnr").values())
            self._eval_merge_base = allreduce_metrics(
                self.eval_history, keys, base=self._eval_merge_base)

    # ------------------------------------------------------------------
    # Halo tiling
    # ------------------------------------------------------------------

    def evaluate_tiled(self, image: torch.Tensor, generator: torch.Generator,
                       image_shape=None) -> Dict:
        """Halo-tiled dense pass over the padded (H, W) ``image`` on the
        device, for a micrograph above `tile_eval_threshold`
        (train.py:1118-1152): fixed-size tiles with a halo run through the
        same dense forward, each chunk with fresh noise from ``generator``,
        and are stitched on the device.  ``image_shape``: the unpadded
        shape, where "auto" takes its probe.  Returns per-image outputs
        shaped like the whole-image path's."""
        from spr_pick_tpu_torch.parallel.tiling import tiled_dense_apply

        apply_tiles = self._tile_apply_fn(generator)
        halo = self.tile_eval_halo
        if halo == "auto":
            halo = self._calibrated_halo(apply_tiles, image, image_shape)
        fns = [apply_tiles] + [self._replica_apply_fn(r, generator)
                               for r in self._replicas]
        stitched = tiled_dense_apply(fns, image, tile=self.tile_eval_size,
                                     halo=halo, align=32)
        return {k: v[None, :, :, None] for k, v in stitched.items()}

    def _replica_apply_fn(self, replica: Denoiser,
                          generator: torch.Generator):
        """`_tile_apply_fn` on a replica on another card: a joint model's
        sample noise is drawn from ``generator`` on its own device, in the
        order of the chunks (what the one-card pass draws for the same
        chunk), and carried over."""

        def apply_tiles(chunk):
            draws = {}
            if replica.mode == "joint":
                shape = tuple(chunk.shape[:3]) + (replica.in_channels,)
                draws["eps"] = torch.randn(
                    shape, generator=generator,
                    device=generator.device).to(replica.device)
            outputs = eval_step(replica, {"inp": chunk.to(replica.device)},
                                **draws)
            return {k: v for k, v in outputs.items()
                    if v.ndim == 4 and v.shape[1:3] == chunk.shape[1:3]}

        return apply_tiles

    def _tile_apply_fn(self, generator: torch.Generator):
        """The dense forward over a chunk of windows, keeping only the
        per-pixel maps of the window's shape; each call draws fresh noise
        from ``generator``, so no two chunks share a noise field."""

        def apply_tiles(chunk):
            outputs = eval_step(self.denoiser, {"inp": chunk},
                                generator=generator)
            return {k: v for k, v in outputs.items()
                    if v.ndim == 4 and v.shape[1:3] == chunk.shape[1:3]}

        return apply_tiles

    def _calibrated_halo(self, apply_tiles, image: torch.Tensor,
                         image_shape=None) -> int:
        """tile_eval_halo="auto": the halo from the model's measured context
        decay on a central crop (train.py:1154-1217), cached per weight set.

        The probe is cropped from the UNPADDED content (a crop of pad can
        understate the decay), and calibration runs at a SMALLER tile than
        production so the probe has window edges with exactly-halo context
        (`calibrate_halo`).  When no candidate meets the tolerance, the
        widest usable candidate (default 96) is used with a warning."""
        from spr_pick_tpu_torch.parallel.tiling import (calibrate_halo,
                                                        usable_halos)

        fp = self._weights_fingerprint()
        if self._auto_halo is not None and self._auto_halo[0] == fp:
            return self._auto_halo[1]
        ih, iw = image_shape if image_shape is not None else image.shape
        ih, iw = min(ih, image.shape[0]), min(iw, image.shape[1])
        side = min(ih, iw, self.tile_eval_size + 2 * max(HALO_CANDIDATES) + 32)
        side -= side % 32
        y0 = (ih - side) // 2
        x0 = (iw - side) // 2
        probe = image[y0 : y0 + side, x0 : x0 + side]
        cal_tile = min(
            self.tile_eval_size,
            max(128, (side - max(HALO_CANDIDATES)) // 2 // 32 * 32),
        )
        try:
            halo, curve = calibrate_halo(apply_tiles, probe, tile=cal_tile,
                                         halos=HALO_CANDIDATES, align=32)
            logger.info(
                "tile halo calibrated to %d (probe %dpx, tile %d; p99 "
                "deviation curve: %s)", halo, side, cal_tile,
                {k: round(v, 4) for k, v in curve.items()},
            )
        except ValueError as exc:
            usable = usable_halos((side, side), cal_tile, HALO_CANDIDATES)
            halo = max(usable, default=96)
            curve = getattr(exc, "curve", {})
            logger.warning("halo auto-calibration inconclusive (%s); using %d",
                           exc, halo)
        self._auto_halo = (fp, halo, curve)
        return halo

    def _weights_fingerprint(self):
        """(step, float32 abs-sum of the trainable weights): two weight sets
        at the same step still differ by the checksum.  One scalar crosses
        to the host."""
        d = self.denoiser
        tensors = list(d.model.parameters()) + list(d.l_params.values())
        if d.sigma_model is not None:
            tensors += list(d.sigma_model.parameters())
        with torch.no_grad():
            total = sum(t.float().abs().sum() for t in tensors)
        return self.step, float(total)

    # ------------------------------------------------------------------
    # Artifacts
    # ------------------------------------------------------------------

    def _submit_export(self, fn, *args) -> None:
        """Run an artifact write on the export pool (inline when
        SPR_EXPORT_THREADS=0).  `_flush_exports` joins and re-raises."""
        n = int(os.environ.get("SPR_EXPORT_THREADS", "4"))
        if n <= 0:
            fn(*args)
            return
        if self._export_pool is None:
            self._export_pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="spr-export")
        self._pending_exports.append(self._export_pool.submit(fn, *args))
        # Backpressure: each pending future pins a quantised map; past a
        # small multiple of the workers, sweep finished futures (re-raising
        # their failures) and block on the oldest.
        if len(self._pending_exports) > 4 * n:
            keep = []
            for i, fut in enumerate(self._pending_exports):
                if i == 0 or fut.done():
                    fut.result()
                else:
                    keep.append(fut)
            self._pending_exports = keep

    def _flush_exports(self) -> None:
        """Wait for all in-flight artifact writes; propagate any failure."""
        pending, self._pending_exports = self._pending_exports, []
        for fut in pending:
            fut.result()

    def img_outputs(self, prefix: str = None) -> Dict:
        outputs = {PipelineOutput.IMG_DENOISED: "out"}
        if self.cfg[ConfigValue.PIPELINE] == Pipeline.SSDN:
            outputs[PipelineOutput.IMG_MU] = "mu_out"
        if prefix:
            outputs = {k: f"{prefix}_{v}" for k, v in outputs.items()}
        return outputs

    def save_image_outputs(self, outputs: Dict, item: Dict, output_dir: str,
                           fileformat: str, scoreformat: str = None):
        """nsy/out/out-mu/out-target/out-std/pred_tar PNGs and the NMS
        `_scores.txt` (train.py:1253-1324)."""
        os.makedirs(output_dir, exist_ok=True)
        name = item["name"]
        shape = item["image_shape"]

        def path_for(desc, fmt):
            return os.path.join(
                output_dir, fmt.format(name=name, iter=self.iteration,
                                       desc=desc))

        def unpad_save(arr, desc):
            if isinstance(arr, torch.Tensor):
                # Quantise on the device; the copy to the host, the PNG
                # encode and the write run on the export pool.
                u8 = quantize_u8_device(arr, shape)
                self._submit_export(save_u8_image, u8, path_for(desc, fileformat))
                return
            img = unpad(np.asarray(arr)[0, :, :, 0], shape)
            self._submit_export(save_array_image, img, path_for(desc, fileformat))

        unpad_save(item["inp"], "nsy")
        if PipelineOutput.IMG_DENOISED in outputs:
            unpad_save(outputs[PipelineOutput.IMG_DENOISED], "out")
        if PipelineOutput.IMG_MU in outputs:
            unpad_save(outputs[PipelineOutput.IMG_MU], "out-mu")
        if item.get("hm") is not None:
            unpad_save(item["hm"], "out-target")
        if PipelineOutput.MODEL_STD_DEV in outputs:
            unpad_save(outputs[PipelineOutput.MODEL_STD_DEV], "out-std")
        if PipelineOutput.DETECT in outputs and scoreformat is not None:
            unpad_save(outputs[PipelineOutput.DETECT], "pred_tar")
            picks = outputs.get("_picks")
            if picks is None:
                (picks,) = self._cfg_picks(outputs, shape)
            self.write_scores(
                outputs[PipelineOutput.DETECT][0, : shape[0], : shape[1], 0],
                name, path_for("scores", scoreformat), picks=picks)

    def write_scores(self, heatmap: torch.Tensor, name: str, out_path: str,
                     picks: Picks):
        """K1's ``picks`` (scores, coords) on ``heatmap``, the micrograph's
        detector map -> its `_scores.txt` (train.py:1326-1360): `tbl.picks`
        with the 30 px border filter and the reference's swapped columns."""
        with open(out_path, "w") as f:
            tbl.write_tsv(f, tbl.picks(name, *picks, heatmap.shape, 30))

    # ------------------------------------------------------------------
    # Metrics, run dir
    # ------------------------------------------------------------------

    def eval_state_str(self, prefix: str = "EVAL") -> str:
        parts = [
            "{}={:8.2f}".format(key, float(np.mean(m.accumulated())))
            for key, m in self.eval_history.items()
            if isinstance(m, Metric) and not m.empty()
        ]
        return "{} | ".format(prefix) + ", ".join(parts)

    @property
    def writer(self) -> ScalarWriter:
        """The run dir's tfevents/JSONL scalar writer; a resumed run purges
        the scalars it logs again (train.py:1599-1606)."""
        os.makedirs(self.run_dir_path, exist_ok=True)
        if self._writer is None:
            self._writer = ScalarWriter(self.run_dir_path,
                                        purge_step=self.iteration + 1)
        return self._writer

    @property
    def run_dir_path(self) -> str:
        return os.path.join(self.runs_dir, self.run_dir)

    @property
    def run_dir(self) -> str:
        if self._run_dir is None:
            self._run_dir = "{:05d}-{}-{}".format(
                self.next_run_id(), self.RUN_KIND, self.config_name())
        return self._run_dir

    def next_run_id(self) -> int:
        run_ids = []
        if os.path.exists(self.runs_dir):
            for run_dir_path, _, _ in os.walk(self.runs_dir):
                try:
                    run_ids.append(int(os.path.basename(run_dir_path)
                                       .split("-")[0]))
                except ValueError:
                    continue
        return max(run_ids) + 1 if run_ids else 0

    def config_name(self) -> str:
        """Parity: train.py:1631-1653."""
        iterations = (self.iteration if self.iteration > 0
                      else self.cfg[ConfigValue.ITERATIONS])
        if iterations >= 1000000:
            iters = "iter%dm" % (iterations // 1000000)
        elif iterations >= 1000:
            iters = "iter%dk" % (iterations // 1000)
        else:
            iters = "iter%d" % iterations
        lst = [cfg_mod.config_name(self.cfg), iters]
        for key in (ConfigValue.TEST_DATASET_NAME,
                    ConfigValue.TRAIN_DATASET_NAME):
            if self.cfg.get(key) is not None:
                lst = [self.cfg[key]] + lst
        lst += [str(self.cfg[ConfigValue.ALPHA]), str(self.cfg[ConfigValue.TAU])]
        return "-".join(lst + [self.mode])


class DenoiserEvaluator(EvaluatorBase):
    """Owns a Denoiser loaded from a `.training` or `.wt` checkpoint (the
    port's, the JAX package's or the reference's), its test data, and the
    eval run dir (created on `evaluate`).

    ``devices``: cards to deal the windows of a tiled frame to, each with a
    replica of the model (the first is the evaluator's device); ``mesh``:
    the ranks that share the micrograph list.
    """

    def __init__(self, state_path: str, runs_dir: str = cfg_mod.DEFAULT_RUN_DIR,
                 mode: str = "joint", device=None, devices=None, mesh=None):
        if devices:
            if device is not None and torch.device(device) != torch.device(
                    devices[0]):
                raise ValueError(f"device {device} is not devices[0] "
                                 f"({devices[0]})")
            device = devices[0]
        super().__init__(runs_dir, device=device, mesh=mesh)
        if not os.path.exists(state_path):
            raise FileNotFoundError(f"Checkpoint does not exist: {state_path}")
        state = ckpt.load(state_path, mode=mode)
        self.cfg = state["cfg"]
        self.mode = state.get("mode") or mode
        self.denoiser = Denoiser(self.cfg, mode=self.mode, device=self.device)
        self.denoiser.load_variables(state["trainable"], state["static"])
        for d in (devices or [])[1:]:
            replica = Denoiser(self.cfg, mode=self.mode,
                               device=resolve_device(d))
            replica.load_variables(state["trainable"], state["static"])
            self._replicas.append(replica)
        training = "training" in state.get("format", "") or "opt_state" in state
        self.iteration = int(state["iteration"]) if training else 0
        # The optimizer step, for the weight fingerprint (train.py:1461).
        self.step = self.iteration // max(
            self.cfg[ConfigValue.TRAIN_MINIBATCH_SIZE], 1)
        # One noise stream for the evaluator's life: every forward (a group,
        # or a tile chunk) draws fresh sample noise from it.
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(self.cfg.get(ConfigValue.SEED, 0)))
        self.eval_history = MetricDict()

    def evaluate(self):
        """Parity: eval.py:46-61."""
        if self.testset is None:
            if not self.cfg.get(ConfigValue.TEST_DATA_PATH):
                raise ValueError("Test dataset not set")
            self.testset, self.test_sampler = self.test_data()
        self._agree_run_dir()
        if self.is_main:
            _ = self.writer
            setup_logging(self.run_dir_path, "log.txt")
        logger.info(separator())
        logger.info("EVALUATING...")
        self.reset_metrics()
        self._evaluate(output_callback=self.eval_output_callback(),
                       picks_for_all=True)
        logger.info("EVALUATION RESULT: %s", self.eval_state_str())
        logger.info(separator())

    def eval_output_callback(self):
        def callback(idx: int, outputs: Dict, item: Dict):
            self.save_image_outputs(
                outputs, item, os.path.join(self.run_dir_path, "eval_imgs"),
                "{name}_{desc}.png", "{name}_{desc}.txt",
            )

        return callback

    def reset_metrics(self):
        self._eval_merge_base = None
        self.eval_history["n"] = 0
        for metric in self.eval_history.values():
            if isinstance(metric, Metric):
                metric.reset()
