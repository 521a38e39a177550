"""Training orchestration: run dirs, the loop, intervals, snapshots and
validation.

The PyTorch port of `spr_pick_tpu/train.py` (`DenoiserTrainer` and
`resume_run`; parity: `spr_pick/train.py`), in joint mode and in
denoise-only mode.  The steps between two print, eval or snapshot
boundaries run as one chunk where the JAX trainer runs its K-step scan
(train.py:634-710), with metrics kept on the device until a boundary:

  * a TXT manifest with coordinates (joint training; also denoise-only
    ssdn) takes `data/micrograph.py:DevicePatchPipeline`, or
    `HostPatchPipeline` past the device budget or under
    ``SPR_HOST_JOINT_DATA=1``, fed by the sampler;
  * a folder of micrographs (denoise-only) takes
    `data/patches.py:DeviceDenoisePipeline`, or `DenoisePatchPipeline` past
    the budget or under ``SPR_HOST_DENOISE_DATA=1``, each drawing its own
    batch.

On a device plane a chunk of K > 1 steps (any K under a mesh) is one call
of `steps.make_train_scan` or `make_denoise_scan` (their sharded forms
under a mesh): the host draws the K batches' indices, labels and flips and
the K learning rates, and on a CUDA device each step is a replay of one
CUDA graph of the step (`utils/cuda_graph.py`; under an NCCL mesh its
collectives are captured too), on the CPU the step itself.  The host
planes, and a single step between two boundaries, take `steps.train_step`
once a step (`_can_scan`, train.py:793-810).

Intervals fire on crossings of their multiples, not exact hits
(`interval_due`), so a batch that does not divide an interval still fires
every boundary.  Validation is the dense evaluation pass of
`eval.py:EvaluatorBase` with the modules in eval mode: a joint model's
picks go through K1, a denoise-only model writes images and PSNR only.
Snapshots are `training_jt/` (joint) or `training_dn/` (denoise)
`model_{iter:08d}.training` in the JAX package's format, and a completed
run writes `final-<config>.wt`.  SIGTERM/SIGINT snapshot and stop at the
next boundary, without a `final-*.wt`.

Randomness: the sampler, the flips and the host denoise plane are numpy
`RandomState`s, as in the JAX package, so they draw the same indices,
crops and noise; a chunk draws its K batches' flips in one call, the same
numbers as K steps draw (the JAX scan draws its flips in the program).
The pipeline's sample noise and flip draw come from a `torch.Generator`
derived from the JAX key's value (``PRNGKey(seed + 1)``), and the device
denoise plane draws from its own generator; their states
are saved in every `.training`, so a resumed run draws what the
uninterrupted one would.  Validation draws its noise from a generator
seeded with the cfg seed at each pass.  The device is the GPU unless the
caller passes another (`utils/device.py`).

Data parallel (``mesh``, `parallel/mesh.py`; the JAX trainer's mesh,
train.py:201-221): each rank runs this loop on its own card, holds its
share of the device plane's image stack (`_shard`; the budget is a card's
times the ranks), draws the same global batch, whose crops the ranks
gather from the shards that hold them, keeps its rows (`next_batch`), and
steps in lockstep with the others (the step averages the gradients; on
cards every rank replays its graph of the step, the collectives in it);
the ranks start from rank 0's variables, stop together on a signal to any
of them, validate on their shares of the micrographs, and rank 0 alone
writes snapshots, `.wt`, scalars and the log.  The data state is the
global one, so a run resumes at any number of ranks.
"""

from __future__ import annotations

import logging
import math
import os
import signal
import threading
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import weights
from spr_pick_tpu_torch.data.folder import image_dataset
from spr_pick_tpu_torch.data.micrograph import (DevicePatchPipeline,
                                                HostPatchPipeline,
                                                MicrographDataset)
from spr_pick_tpu_torch.data.patches import (DenoisePatchPipeline,
                                             DeviceDenoisePipeline)
from spr_pick_tpu_torch.data.sampler import StratifiedCoordinateSampler
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.eval import EvaluatorBase
from spr_pick_tpu_torch.parallel.mesh import shard_rows
from spr_pick_tpu_torch.params import (ConfigValue, DatasetType, HistoryValue,
                                       PipelineOutput, StateValue)
from spr_pick_tpu_torch.steps import (TrainState, init_state,
                                      make_denoise_scan,
                                      make_denoise_scan_sharded,
                                      make_optimizer, make_train_scan,
                                      make_train_scan_sharded, train_step)
from spr_pick_tpu_torch.utils import checkpoint as ckpt
from spr_pick_tpu_torch.utils.logging_helper import setup as setup_logging
from spr_pick_tpu_torch.utils.metrics import (Metric, MetricDict, TrackedTime,
                                              seconds_to_dhms, separator)
from spr_pick_tpu_torch.utils.profiling import Trace
from spr_pick_tpu_torch.utils.schedule import compute_ramped_lrate

logger = logging.getLogger("train")

DEFAULT_RUN_DIR = cfg_mod.DEFAULT_RUN_DIR


def _device_data_budget(mesh=None) -> int:
    """Device byte budget of the micrograph stack: 4 GiB a card by default
    (SPR_DEVICE_DATA_BUDGET overrides, in bytes a card), times the ranks of
    ``mesh``, over which the stack is sharded (train.py:76-85)."""
    per_card = int(os.environ.get("SPR_DEVICE_DATA_BUDGET", 4 << 30))
    return per_card * (mesh.size if mesh is not None else 1)


def interval_due(fired: Dict[str, int], kind: str, interval,
                 iteration: int) -> bool:
    """Whether ``iteration`` crossed a multiple of ``interval`` since the
    last time ``kind`` fired (train.py:564-582); records the firing."""
    if not interval or interval <= 0:
        return False
    if iteration // interval > fired[kind] // interval:
        fired[kind] = iteration
        return True
    return False


def _key_generator(key: np.ndarray, device) -> torch.Generator:
    """The torch stream the port derives from a JAX uint32[2] key."""
    seed = (int(key[0]) << 32) | int(key[1])
    return torch.Generator(device=device).manual_seed(seed)


class DenoiserTrainer(EvaluatorBase):
    """Owns a Denoiser, its TrainState, the data planes and the run dir."""

    RUN_KIND = "train"

    def __init__(self, cfg: Optional[Dict], mode: str = "joint",
                 alpha: Optional[float] = None, tau: Optional[float] = None,
                 runs_dir: str = DEFAULT_RUN_DIR, run_dir: Optional[str] = None,
                 profile: bool = False, device=None, mesh=None):
        super().__init__(runs_dir, run_dir=run_dir, device=device, mesh=mesh)
        if mode not in ("joint", "denoise"):
            raise ValueError(f"mode {mode!r}: expected 'joint' or 'denoise'")
        self.profile = profile
        self.cfg = cfg
        self.mode = mode
        # cfg is the single source of truth for the loss weights: explicit
        # arguments write through to it, omitted ones read it.
        if self.cfg:
            cfg_mod.infer(self.cfg)
            if alpha is not None:
                self.cfg[ConfigValue.ALPHA] = float(alpha)
            if tau is not None:
                self.cfg[ConfigValue.TAU] = float(tau)
            self.alpha = float(self.cfg.get(ConfigValue.ALPHA, 0.8))
            self.tau = float(self.cfg.get(ConfigValue.TAU, 0.01))
        else:
            # Shell trainer (resume): the checkpoint's cfg arrives in
            # load_state_dict.
            self.alpha = 0.8 if alpha is None else float(alpha)
            self.tau = 0.01 if tau is None else float(tau)
        self.state: Dict = {}
        self.init_state()
        self.denoiser: Optional[Denoiser] = None
        self.train_state: Optional[TrainState] = None
        self._rng_key: Optional[np.ndarray] = None
        self._train_generator: Optional[torch.Generator] = None
        self._pending_data_state = None
        # Set by SIGTERM/SIGINT; checked at chunk boundaries in train().
        self._stop_requested = False
        self.trainset: Optional[MicrographDataset] = None
        self.patch_pipeline = None
        self.train_sampler = None
        # The K-step chunk function of a device data plane (None: per step).
        self._scan = None

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def init_state(self):
        self.state[StateValue.INITIALISED] = True
        self.state[StateValue.ITERATION] = 0
        self.state[StateValue.HISTORY] = {
            HistoryValue.TRAIN: MetricDict(),
            HistoryValue.EVAL: MetricDict(),
            HistoryValue.TIMINGS: defaultdict(TrackedTime),
        }
        self.reset_metrics()

    def _new_denoiser(self) -> Denoiser:
        return Denoiser(self.cfg, mode=self.mode, device=self.device,
                        mesh=self.mesh)

    def _sync_ranks(self) -> None:
        """Every rank of a mesh starts from rank 0's variables."""
        if self.mesh is not None:
            self.mesh.broadcast_(self.denoiser.state_tensors())

    def new_target(self):
        """Fresh Denoiser + TrainState (train.py:186-199)."""
        self.denoiser = self._new_denoiser()
        seed = int(self.cfg.get(ConfigValue.SEED, 0))
        self.train_state = init_state(self.denoiser, seed=seed)
        self._sync_ranks()
        # The value of jax.random.PRNGKey(seed + 1).
        self._rng_key = np.array([0, seed + 1], np.uint32)
        self._train_generator = _key_generator(self._rng_key, self.device)
        self.init_state()

    @property
    def iteration(self) -> int:
        return self.state[StateValue.ITERATION]

    @property
    def step(self) -> int:
        return 0 if self.train_state is None else self.train_state.step

    @property
    def eval_history(self) -> MetricDict:
        return self.state[StateValue.HISTORY][HistoryValue.EVAL]

    @property
    def base_learning_rate(self) -> float:
        return float(self.cfg.get(ConfigValue.LEARNING_RATE) or 1e-4)

    @property
    def learning_rate(self) -> float:
        # Ramp-down and ramp-up swapped, as at the reference's call site
        # (train.py:244-250).
        return compute_ramped_lrate(
            self.state[StateValue.ITERATION],
            self.cfg[ConfigValue.ITERATIONS],
            self.cfg[ConfigValue.LR_RAMPDOWN_FRACTION],
            self.cfg[ConfigValue.LR_RAMPUP_FRACTION],
            self.base_learning_rate,
        )

    # ------------------------------------------------------------------
    # Data
    # ------------------------------------------------------------------

    def train_data(self):
        """Training dataset, sampler (None: the pipeline draws its own
        batch) and patch pipeline (train.py:279-374).  The joint route takes
        the device plane within the budget, else, or under
        ``SPR_HOST_JOINT_DATA=1``, the host plane (not sharded, and stepped
        one batch at a time: no chunk is built for it)."""
        cfg = self.cfg
        dtype = cfg[ConfigValue.TRAIN_DATASET_TYPE]
        if dtype != DatasetType.TXT:
            return self._denoise_train_data(dtype)
        patch = cfg[ConfigValue.TRAIN_PATCH_SIZE]
        dataset = MicrographDataset(
            cfg[ConfigValue.TRAIN_DATA_PATH], cfg[ConfigValue.TRAIN_LABEL_PATH],
            radius=3, crop=patch, gt_path=cfg[ConfigValue.TRAIN_GT_PATH],
            bb=cfg[ConfigValue.BB],
        )
        sampler = StratifiedCoordinateSampler(
            list(dataset.targets), balance=0.1,
            size=cfg[ConfigValue.ITERATIONS]
            * cfg[ConfigValue.TRAIN_MINIBATCH_SIZE],
            random=np.random.RandomState(int(cfg.get(ConfigValue.SEED, 0))),
        )
        if os.environ.get("SPR_HOST_JOINT_DATA", "0") != "1":
            try:
                pipeline = DevicePatchPipeline(
                    dataset, crop=patch, augment=True,
                    max_bytes=_device_data_budget(self.mesh),
                    device=self.device)
            except ValueError as exc:
                logger.warning(
                    "device joint data plane unavailable (%s); falling back "
                    "to host batch prep - dataset capacity is now "
                    "host-RAM-bound, like the reference's DataLoader path",
                    exc)
            else:
                self._shard(pipeline)
                return dataset, sampler, pipeline
        logger.info("joint data plane: HostPatchPipeline (host batch prep, "
                    "one train step a batch)")
        return dataset, sampler, HostPatchPipeline(
            dataset, crop=patch, augment=True, device=self.device)

    def _denoise_train_data(self, dtype):
        """The folder and HDF5 routes of denoise-only training
        (train.py:329-374): the device plane within the budget, else, or
        under ``SPR_HOST_DENOISE_DATA=1``, the host plane."""
        if self.mode != "denoise":
            raise NotImplementedError(
                "joint training needs particle coordinates (TXT manifest); "
                "folder/hdf5 datasets support denoise-only training "
                "(--dn_only)")
        cfg = self.cfg
        base = image_dataset(dtype, cfg[ConfigValue.TRAIN_DATA_PATH],
                             cfg[ConfigValue.IMAGE_CHANNELS])
        kwargs = dict(
            patch=cfg[ConfigValue.TRAIN_PATCH_SIZE],
            algorithm=cfg[ConfigValue.ALGORITHM],
            noise_style=cfg[ConfigValue.NOISE_STYLE],
            seed=int(cfg.get(ConfigValue.SEED, 0)),
            noise_input=bool(cfg.get(ConfigValue.NOISE_INPUT, False)),
            device=self.device,
        )
        if os.environ.get("SPR_HOST_DENOISE_DATA", "0") != "1":
            try:
                pipeline = DeviceDenoisePipeline(
                    base, max_bytes=_device_data_budget(self.mesh), **kwargs)
            except ValueError as exc:
                logger.warning("device denoise data plane unavailable (%s); "
                               "falling back to host batch prep", exc)
            else:
                self._shard(pipeline)
                return base, None, pipeline
        return base, None, DenoisePatchPipeline(base, **kwargs)

    def _shard(self, pipeline) -> None:
        """Under a mesh, shard a device plane's stack over the ranks before
        its first use (train.py:519-536, :660-669, :700-705), and log each
        rank's share."""
        if self.mesh is None:
            return
        pipeline.shard_over(self.mesh)
        if not self.mesh.is_main:
            return
        n, h, w = pipeline.stack.shape
        row_bytes = h * w * 4
        for r in range(self.mesh.size):
            offset, rows = shard_rows(n, self.mesh.size, r)
            logger.info(
                "rank %d/%d holds stack rows [%d, %d) (%d of them images), "
                "%.1f MiB of the %.1f MiB stack", r, self.mesh.size, offset,
                offset + rows, max(0, min(rows, n - offset)),
                rows * row_bytes / 2**20, n * row_bytes / 2**20)

    def set_train_data(self, path: str):
        self.cfg[ConfigValue.TRAIN_DATA_PATH] = path
        self.cfg[ConfigValue.TRAIN_DATASET_TYPE] = None
        cfg_mod.infer_datasets(self.cfg)

    def set_train_label(self, path: str):
        self.cfg[ConfigValue.TRAIN_LABEL_PATH] = path

    def set_train_gt_data(self, path: str):
        self.cfg[ConfigValue.TRAIN_GT_PATH] = path

    # ------------------------------------------------------------------
    # Training loop
    # ------------------------------------------------------------------

    def _install_stop_handlers(self):
        """SIGTERM/SIGINT -> snapshot and stop at the next boundary
        (train.py:447-487); a second SIGINT raises KeyboardInterrupt.
        Returns restore(); a no-op off the main thread."""
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def handler(signum, frame):
            if self._stop_requested and signum == signal.SIGINT:
                raise KeyboardInterrupt
            self._stop_requested = True
            logger.warning(
                "received %s - will snapshot and stop at the next window "
                "boundary (repeat Ctrl-C to kill)", signal.Signals(signum).name,
            )

        prev = {s: signal.signal(s, handler)
                for s in (signal.SIGTERM, signal.SIGINT)}

        def restore():
            for s, h in prev.items():
                signal.signal(s, h)

        return restore

    def train(self):
        if self.denoiser is None:
            self.new_target()
        self._agree_run_dir()
        if self.is_main:
            _ = self.writer
            setup_logging(self.run_dir_path, "log.txt")
        logger.info(separator())
        logger.info("Loading Training Dataset...")
        self.trainset, self.train_sampler, self.patch_pipeline = \
            self.train_data()
        if self._pending_data_state:
            self.load_data_state_dict(self._pending_data_state)
            self._pending_data_state = None
            logger.info("restored data-plane state (sampler + augment RNGs)")
        logger.info("Loaded Training Dataset.")
        if self.cfg[ConfigValue.TEST_DATA_PATH]:
            logger.info("Loading Validation Dataset...")
            self.testset, self.test_sampler = self.test_data()
            logger.info("Loaded Validation Dataset.")

        if self._scan is None:
            self._scan = self._build_scan()
        self._stop_requested = False
        restore_handlers = self._install_stop_handlers()
        try:
            logger.info(separator())
            logger.info("TRAINING STARTED")
            logger.info(separator())
            history = self.state[StateValue.HISTORY]
            batch_size = self.cfg[ConfigValue.TRAIN_MINIBATCH_SIZE]
            # Metrics stay on the device until a boundary flushes them.
            pending_metrics = []
            capture = None
            if self.profile and self.is_main:
                capture = Trace(os.path.join(self.run_dir_path, "profile"))
            fired = dict.fromkeys(("eval", "print", "snapshot"),
                                  self.state[StateValue.ITERATION] - 1)
            self.denoiser.train()
            while True:
                iteration = self.state[StateValue.ITERATION]
                if self._stop_agreed():
                    # No final-*.wt: that file means the run completed.
                    self._flush_metrics(pending_metrics, batch_size)
                    if capture is not None:
                        capture.stop()
                    self.snapshot()
                    logger.info(separator())
                    logger.info(
                        "TRAINING STOPPED at iteration %d (signal) - resume "
                        "with `train resume %s`", iteration, self.run_dir_path,
                    )
                    logger.info(separator())
                    return
                if self.testset is not None and interval_due(
                        fired, "eval", self.cfg[ConfigValue.EVAL_INTERVAL],
                        iteration):
                    self._flush_metrics(pending_metrics, batch_size)
                    self.validate()
                if interval_due(fired, "print",
                                self.cfg[ConfigValue.PRINT_INTERVAL],
                                iteration):
                    self._flush_metrics(pending_metrics, batch_size)
                    if capture is not None and iteration > 0:
                        logger.info("profiler trace written to %s",
                                    capture.stop())
                        capture = None
                    history[HistoryValue.TIMINGS]["total"].update()
                    last_print = history[HistoryValue.TIMINGS]["last_print"]
                    last_print.update()
                    samples = (history[HistoryValue.EVAL]["n"]
                               + history[HistoryValue.TRAIN]["n"])
                    self.update_eta(samples, last_print.total)
                    logger.info(self.state_str(eval_prefix="VALID"))
                    if self.is_main:
                        self.write_metrics(eval_prefix="valid")
                    last_print.total = 0
                    self.reset_metrics()
                if interval_due(fired, "snapshot",
                                self.cfg[ConfigValue.SNAPSHOT_INTERVAL],
                                iteration):
                    self._flush_metrics(pending_metrics, batch_size)
                    self.snapshot()
                if iteration >= self.cfg[ConfigValue.ITERATIONS]:
                    break
                k = self._chunk_steps(iteration, batch_size)
                if self._scan is not None and (
                        k > 1 or self.mesh is not None):
                    pending_metrics.append(
                        (self._run_chunk(iteration, k, batch_size), k))
                    self.state[StateValue.ITERATION] += k * batch_size
                    continue
                for _ in range(k):
                    pending_metrics.append((train_step(
                        self.train_state, self.next_batch(batch_size),
                        self.learning_rate,
                        self.alpha, self.tau, generator=self._train_generator,
                    ), 1))
                    self.state[StateValue.ITERATION] += batch_size

            self._flush_metrics(pending_metrics, batch_size)
            if capture is not None:
                capture.stop()
            self._log_chunks()
            logger.info(separator())
            logger.info("TRAINING FINISHED")
            logger.info(separator())
            self.snapshot()
            self.snapshot(output_name="final-{}.wt".format(self.config_name()),
                          subdir="", model_only=True)
        finally:
            restore_handlers()

    def _stop_agreed(self) -> bool:
        """The stop flag, set on any rank of a mesh (every rank stops at the
        same boundary)."""
        if self.mesh is None:
            return self._stop_requested
        return self.mesh.any(self._stop_requested)

    def next_batch(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The data plane's next batch: the sampler's indices, or the
        pipeline's own draw where there is no sampler (folders).  Each rank
        of a mesh draws the same global batch and keeps its rows, so the
        data state stays global."""
        if self.train_sampler is None:
            batch = self.patch_pipeline.batch(batch_size)
        else:
            batch = self.patch_pipeline.batch(
                self.train_sampler.sample_batch(batch_size))
        return batch if self.mesh is None else self.mesh.local(batch)

    def _chunk_steps(self, iteration: int, batch_size: int) -> int:
        """Steps until the next eval/print/snapshot/end boundary
        (train.py:755-767): the loop checks intervals and the stop flag
        between chunks."""
        intervals = [self.cfg[ConfigValue.PRINT_INTERVAL],
                     self.cfg[ConfigValue.SNAPSHOT_INTERVAL]]
        if self.testset is not None:
            intervals.append(self.cfg[ConfigValue.EVAL_INTERVAL])
        boundary = min((((iteration // iv) + 1) * iv
                        for iv in intervals if iv and iv > 0),
                       default=self.cfg[ConfigValue.ITERATIONS])
        boundary = min(boundary, self.cfg[ConfigValue.ITERATIONS])
        return max((boundary - iteration) // batch_size, 1)

    def _scan_lrs(self, iteration: int, k: int,
                  batch_size: int) -> np.ndarray:
        """The K steps' learning rates of a chunk (train.py:769-783)."""
        return np.array([
            compute_ramped_lrate(
                iteration + i * batch_size, self.cfg[ConfigValue.ITERATIONS],
                self.cfg[ConfigValue.LR_RAMPDOWN_FRACTION],
                self.cfg[ConfigValue.LR_RAMPUP_FRACTION],
                self.base_learning_rate)
            for i in range(k)], np.float32)

    def _build_scan(self):
        """The chunk function of a device data plane (train.py:518-545,
        sharded under a mesh); None for the host planes."""
        pipe = self.patch_pipeline
        if (isinstance(pipe, DevicePatchPipeline)
                and self.train_sampler is not None):
            if self.mesh is None:
                return make_train_scan(self.denoiser, self.alpha, self.tau,
                                       crop=pipe.crop)
            return make_train_scan_sharded(self.denoiser, self.alpha,
                                           self.tau, pipe.crop, self.mesh)
        if isinstance(pipe, DeviceDenoisePipeline):
            args = (self.denoiser, self.alpha, self.tau, pipe.patch,
                    pipe.algorithm, pipe.noise_style)
            if self.mesh is None:
                return make_denoise_scan(*args, noise_input=pipe.noise_input)
            return make_denoise_scan_sharded(*args, self.mesh,
                                             noise_input=pipe.noise_input)
        return None

    def _run_chunk(self, iteration: int, k: int,
                   batch_size: int) -> Dict[str, torch.Tensor]:
        """K steps as one chunk (train.py:634-710): the host draws the K
        batches' indices (on the joint plane also their labels and flips)
        and the K learning rates, the chunk function does the rest."""
        pipe = self.patch_pipeline
        lrs = self._scan_lrs(iteration, k, batch_size)
        if self.train_sampler is not None:
            packed = self.train_sampler.sample_batch(k * batch_size)
            flat, ys, xs = pipe.decode(packed.reshape(k, batch_size))
            pipe.check_in_bounds(flat, ys, xs)
            labels = pipe.labels_for(flat, ys, xs)
            flips = pipe.flips((k, batch_size))
            return self._scan(self.train_state, pipe.images_dev, flat, ys,
                              xs, flips, labels, lrs, self._train_generator)
        # One (K, B) draw, as the JAX trainer draws: not the order of K
        # draws of (B,).
        flat, ys, xs = pipe.sample_coords((k, batch_size))
        pipe.count_batches(k)
        return self._scan(self.train_state, pipe.images_dev, flat, ys, xs,
                          lrs, self._train_generator, pipe.generator)

    def _log_chunks(self) -> None:
        chunk = getattr(self._scan, "chunk", None)
        if chunk is not None and (chunk.replays or chunk.eager_steps):
            ranks = ("" if self.mesh is None else
                     f", on each of {self.mesh.size} ranks (NCCL "
                     "collectives captured)")
            logger.info("graphed chunks: %d steps replayed from a CUDA "
                        "graph after %d eager warm-up steps%s",
                        chunk.replays, chunk.eager_steps, ranks)

    def _flush_metrics(self, pending, batch_size: int):
        """Copy the buffered device metrics, ``(metrics, steps)`` pairs of
        one step's per-item values or a chunk's per-step means, to the
        host history (train.py:812-837)."""

        def as_batched(value):
            arr = value.float().cpu().numpy()
            return arr.reshape(1) if arr.ndim == 0 else arr

        train_history = self.state[StateValue.HISTORY][HistoryValue.TRAIN]
        for metrics, steps in pending:
            train_history["n"] += batch_size * steps
            for key in ("loss", "denoise_loss", "det_loss", "aug_loss"):
                if key in metrics:
                    train_history[key] += as_batched(metrics[key])
            for key in (PipelineOutput.NOISE_STD_DEV.value,
                        PipelineOutput.MODEL_STD_DEV.value):
                if key in metrics:
                    train_history[key] += as_batched(metrics[key]) * 255
        pending.clear()

    # ------------------------------------------------------------------
    # Validation
    # ------------------------------------------------------------------

    def validate(self):
        """The dense evaluation pass over the validation set, the modules in
        eval mode, exporting the first micrograph's artifacts
        (train.py:603-608, 1233-1243)."""
        self.denoiser.train(False)
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(self.cfg.get(ConfigValue.SEED, 0)))
        try:
            self._evaluate(output_callback=self.validation_output_callback(0))
        finally:
            self.denoiser.train(True)

    def validation_output_callback(self, output_index: int):
        def callback(idx: int, outputs: Dict, item: Dict):
            if idx == output_index:
                self.save_image_outputs(
                    outputs, item,
                    os.path.join(self.run_dir_path, "val_imgs_" + self.mode),
                    "{name}_{iter:08}_{desc}.png",
                    "{name}_{iter:08}_{desc}.txt",
                )

        return callback

    # ------------------------------------------------------------------
    # Snapshots / resume
    # ------------------------------------------------------------------

    def opt_state(self) -> ckpt.OptState:
        """The optimizer state as optax's ScaleByAdamState(count, mu, nu) of
        numpy trees in the flax layout."""
        opt = self.train_state.opt
        names = self.denoiser.named_trainable()
        return ckpt.ScaleByAdamState(
            np.asarray(opt.count, np.int32),
            weights.named_to_flax((g, k, t) for (g, k, _), t
                                  in zip(names, opt.mu)),
            weights.named_to_flax((g, k, t) for (g, k, _), t
                                  in zip(names, opt.nu)),
        )

    def _load_opt_state(self, opt_state) -> None:
        """Load a ScaleByAdamState (JAX- or port-written) into the
        optimizer: ``count`` is every parameter's Adam step."""
        name = getattr(opt_state, "optax_name", type(opt_state).__name__)
        if name != "ScaleByAdamState":
            raise ckpt.CheckpointError(
                f"optimizer state {name}: only optax.scale_by_adam's "
                "ScaleByAdamState is loaded")
        count, mu, nu = opt_state
        opt = self.train_state.opt
        names = self.denoiser.named_trainable()
        with torch.no_grad():
            for dst, tree in ((opt.mu, mu), (opt.nu, nu)):
                for t, src in zip(dst, weights.flax_to_named(tree, names)):
                    t.copy_(src)
        opt.set_count(int(np.asarray(count)))

    def snapshot(self, output_name: str = None, subdir: str = None,
                 model_only: bool = False):
        """Parity: train.py:1366-1399: `training_jt`/`model_jt` in joint
        mode, `training_dn`/`model_dn` in denoise mode.  Rank 0 alone
        writes; every rank holds the same state."""
        if not self.is_main:
            return
        if subdir is None:
            suffix = "jt" if self.mode == "joint" else "dn"
            subdir = ("model_" if model_only else "training_") + suffix
        output_dir = os.path.join(self.run_dir_path, subdir)
        os.makedirs(output_dir, exist_ok=True)
        iteration = self.state[StateValue.ITERATION]
        trainable, static = self.denoiser.variables()
        if model_only:
            output_name = output_name or "model_{:08d}.wt".format(iteration)
            ckpt.save_weights(os.path.join(output_dir, output_name),
                              trainable, static, self.cfg, self.mode)
            return
        output_name = output_name or "model_{:08d}.training".format(iteration)
        generator = {"device": self._train_generator.device.type,
                     "state": self._train_generator.get_state().numpy()}
        ckpt.save_training(
            os.path.join(output_dir, output_name), trainable, static,
            self.opt_state(), self.cfg, self.mode, iteration,
            rng_key=self._rng_key,
            extra={"data_state": self.data_state_dict(),
                   "torch_generator": generator},
        )

    def data_state_dict(self):
        """Sampler position + augment and noise RNGs (train.py:1401-1419);
        a denoise plane has no sampler."""
        state = {}
        if self.train_sampler is not None:
            state["sampler"] = self.train_sampler.state_dict()
        if self.patch_pipeline is not None:
            state["pipeline"] = self.patch_pipeline.state_dict()
        return state

    def load_data_state_dict(self, state) -> None:
        if not state:
            return
        if "sampler" in state and self.train_sampler is not None:
            self.train_sampler.load_state_dict(state["sampler"])
        if "pipeline" in state and self.patch_pipeline is not None:
            self.patch_pipeline.load_state_dict(state["pipeline"])

    def _load_engine(self, path_or_state) -> Dict:
        """A checkpoint's cfg (with the loss weights it trained with) and
        weights into a fresh Denoiser; returns the loaded state."""
        state = path_or_state
        if isinstance(state, str):
            state = ckpt.load(state, mode=self.mode)
        self.cfg = state["cfg"]
        self.mode = state.get("mode", self.mode) or self.mode
        self.alpha = float(self.cfg.get(ConfigValue.ALPHA, self.alpha))
        self.tau = float(self.cfg.get(ConfigValue.TAU, self.tau))
        self.denoiser = self._new_denoiser()
        self.denoiser.load_variables(state["trainable"], state["static"])
        self._sync_ranks()
        return state

    def load_state_dict(self, path_or_state):
        """Load a `.training` (the port's or the JAX package's) and rebuild
        the engine and state (train.py:1430-1479).  A JAX-written file has
        no torch generator state: the generator is derived from its
        ``rng_key``."""
        state = self._load_engine(path_or_state)
        batch = max(self.cfg[ConfigValue.TRAIN_MINIBATCH_SIZE], 1)
        self.train_state = TrainState(step=state["iteration"] // batch,
                                      denoiser=self.denoiser,
                                      opt=make_optimizer(self.denoiser))
        if state.get("opt_state") is not None:
            self._load_opt_state(state["opt_state"])
        self.state[StateValue.ITERATION] = state["iteration"]
        key = state.get("rng_key")
        self._rng_key = (np.zeros(2, np.uint32) if key is None
                         else np.asarray(key, np.uint32))
        self._train_generator = _key_generator(self._rng_key, self.device)
        extra = state.get("extra") or {}
        saved = extra.get("torch_generator")
        if saved is not None:
            if saved["device"] == self.device.type:
                self._train_generator.set_state(
                    torch.from_numpy(np.asarray(saved["state"])))
            else:
                logger.warning(
                    "snapshot's generator state is for %s, this run is on "
                    "%s: the sample noise is derived from rng_key instead",
                    saved["device"], self.device.type)
        self._pending_data_state = extra.get("data_state")

    def load_weights(self, path_or_state):
        """Load a `.wt` into a fresh engine and optimizer at step 0
        (train.py:1481-1500)."""
        state = self._load_engine(path_or_state)
        self.train_state = TrainState(step=0, denoiser=self.denoiser,
                                      opt=make_optimizer(self.denoiser))
        self._rng_key = np.zeros(2, np.uint32)
        self._train_generator = _key_generator(self._rng_key, self.device)

    # ------------------------------------------------------------------
    # Metrics / strings
    # ------------------------------------------------------------------

    def write_metrics(self, eval_prefix: str = "eval"):
        it = self.state[StateValue.ITERATION]

        def write_metric_dict(metric_dict, prefix):
            for key, metric in metric_dict.items():
                if isinstance(metric, Metric) and not metric.empty():
                    self.writer.add_scalar(prefix + "/" + str(key),
                                           metric.accumulated(), it)

        write_metric_dict(self.state[StateValue.HISTORY][HistoryValue.TRAIN],
                          "train")
        self.writer.add_scalar("train/learning_rate", self.learning_rate, it)
        write_metric_dict(self.eval_history, eval_prefix)

    def state_str(self, eval_prefix: str = "EVAL") -> str:
        state_str = self.train_state_str()
        if self.eval_history["n"] > 0:
            prefix = "{:10} {:>5}".format("", eval_prefix)
            state_str = os.linesep.join([state_str,
                                         self.eval_state_str(prefix)])
        return state_str

    def train_state_str(self) -> str:
        history = self.state[StateValue.HISTORY]
        eta = history[HistoryValue.TIMINGS].get("eta", None)
        if isinstance(eta, (int, float)):
            eta = "<1s" if eta < 1 else seconds_to_dhms(eta)
        else:
            eta = "???"
        summary = "[{:08d}] {:>5} | ".format(self.state[StateValue.ITERATION],
                                             "TRAIN")
        parts = [
            "{}={:8.2f}".format(key, float(np.mean(metric.accumulated())))
            for key, metric in history[HistoryValue.TRAIN].items()
            if isinstance(metric, Metric) and not metric.empty()
        ]
        summary += ", ".join(parts)
        if parts:
            summary += " | "
        total = history[HistoryValue.TIMINGS]["total"]
        return summary + "[{} ~ ETA: {}]".format(
            seconds_to_dhms(total.total, trim=False), eta)

    def reset_metrics(self, eval: bool = True, train: bool = True):
        if eval:
            self._eval_merge_base = None

        def reset(metric_dict):
            metric_dict["n"] = 0
            for metric in metric_dict.values():
                if isinstance(metric, Metric):
                    metric.reset()

        if train:
            reset(self.state[StateValue.HISTORY][HistoryValue.TRAIN])
        if eval:
            reset(self.state[StateValue.HISTORY][HistoryValue.EVAL])

    def update_eta(self, samples: int, elapsed: float, smoothing_factor=0.95):
        """Parity: train.py:1576-1593."""
        timings = self.state[StateValue.HISTORY][HistoryValue.TIMINGS]
        if samples <= 0:
            return timings.get("eta")
        t = elapsed / samples
        r = self.cfg[ConfigValue.ITERATIONS] - self.state[StateValue.ITERATION]
        if self.testset is not None:
            r += len(self.test_sampler) * math.ceil(
                r / self.cfg[ConfigValue.EVAL_INTERVAL])
        new_eta = t * r
        if "eta" not in timings or isinstance(timings["eta"], TrackedTime):
            timings["eta"] = new_eta
        else:
            timings["eta"] = (smoothing_factor * new_eta
                              + (1 - smoothing_factor) * timings["eta"])
        return timings["eta"]


def resume_run(run_dir: str, iteration: int = None, mode: str = None,
               device=None, mesh=None) -> DenoiserTrainer:
    """Resume training from a `.training` snapshot, the latest by default
    or ``model_{iteration:08d}.training`` (train.py:1656-1699), on one
    device or on the ranks of ``mesh``: the data state is global, so a run
    resumes at any number of ranks."""
    path, mode = resume_path(run_dir, iteration, mode)
    run_dir = os.path.abspath(run_dir)
    runs_dir = os.path.abspath(os.path.join(run_dir, ".."))
    logger.info("Loading from '%s'...", path)
    trainer = DenoiserTrainer(None, mode=mode, runs_dir=runs_dir,
                              run_dir=os.path.basename(run_dir), device=device,
                              mesh=mesh)
    trainer.load_state_dict(path)
    logger.info("Loaded training state.")
    for timing in trainer.state[StateValue.HISTORY][
            HistoryValue.TIMINGS].values():
        if isinstance(timing, TrackedTime):
            timing.forget()
    return trainer


def resume_path(run_dir: str, iteration: int = None, mode: str = None):
    """(snapshot path, mode) a resume of ``run_dir`` loads: the mode from
    the snapshot dir present, the latest snapshot unless ``iteration``."""
    run_dir = os.path.abspath(run_dir)
    if mode is None:
        if os.path.isdir(os.path.join(run_dir, "training_jt")):
            mode = "joint"
        elif os.path.isdir(os.path.join(run_dir, "training_dn")):
            mode = "denoise"
        else:
            raise FileNotFoundError(
                f"no training_jt/ or training_dn/ snapshots under {run_dir}")
    subdir = "training_jt" if mode == "joint" else "training_dn"
    if iteration is None:
        path = ckpt.find_latest_training(run_dir, subdir)
    else:
        path = os.path.join(run_dir, subdir, f"model_{iteration:08d}.training")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"no snapshot for iteration {iteration} under "
                f"{os.path.join(run_dir, subdir)}")
    return path, mode
