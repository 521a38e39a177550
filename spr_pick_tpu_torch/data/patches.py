"""Patch pipelines of denoise-only training over unlabelled (folder)
datasets, and whole-image eval access to them.

The PyTorch port of `spr_pick_tpu/data/patches.py` (the reference's
folder/h5 training route, train.py:1035-1048 + NoisyDataset): random patch
crops from whole images and the algorithm-dependent input/reference of
`data/noisy.py`.

  * `DenoisePatchPipeline`, the host plane: numpy crops and noise from one
    `RandomState`, the JAX package's draws bit for bit.
  * `DeviceDenoisePipeline`, the device plane: the image stack lives on the
    device (sharded over the ranks of a mesh after `shard_over`); the host
    draws only the crop coordinates (numpy, as in the JAX package), and
    the gather, noise and UPS masking run as torch ops on the device,
    drawn from a `torch.Generator` seeded with ``seed ^ 0x5EED``.  Those
    draws cannot equal `jax.random`'s.
  * `UnlabeledEvalDataset`, the `test_item` contract over a folder.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from spr_pick_tpu_torch.data.crop import random_crop
from spr_pick_tpu_torch.data.micrograph import (PaddedStack, StackOnDevice,
                                                pad_to_multiple)
from spr_pick_tpu_torch.data.noisy import prepare_batch, prepare_batch_torch
from spr_pick_tpu_torch.params import NoiseAlgorithm

logger = logging.getLogger("patches")


class DenoisePatchPipeline:
    """Random-crop batches from an image dataset for the n2c / n2n / n2v /
    ssdn denoise-only algorithms, prepared on the host and copied to
    ``device``."""

    def __init__(self, dataset, patch: int, algorithm: NoiseAlgorithm,
                 noise_style: Optional[str], seed: int = 0,
                 noise_input: bool = False,
                 device: torch.device | str = "cpu"):
        self.dataset = dataset
        self.patch = patch
        self.algorithm = algorithm
        self.noise_style = noise_style
        self.noise_input = noise_input
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)
        # Folder datasets decode lazily: keep each decoded image.
        self._cache: Dict[int, np.ndarray] = {}

    def _image(self, i: int) -> np.ndarray:
        if i not in self._cache:
            self._cache[i] = np.asarray(self.dataset[i], np.float32)
        return self._cache[i]

    def batch(self, batch_size: int) -> Dict[str, torch.Tensor]:
        crops = np.empty((batch_size, self.patch, self.patch), np.float32)
        for b in range(batch_size):
            idx = self.rng.randint(len(self.dataset))
            crops[b], _, _ = random_crop(self._image(idx), None, self.patch,
                                         self.rng)
        host = prepare_batch(crops, self.algorithm, self.noise_style,
                             self.rng, training=True,
                             noise_input=self.noise_input)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in host.items()}

    def state_dict(self):
        """Crop/noise RNG state (resumable data plane)."""
        return {"rng_state": self.rng.get_state()}

    def load_state_dict(self, sd) -> None:
        self.rng.set_state(sd["rng_state"])


class DeviceDenoisePipeline:
    """The denoise data plane with the image stack on the device.

    Every image is decoded once into one zero-padded (N, Hmax, Wmax)
    float32 stack (undersized images take `random_crop`'s reflect pad
    first), placed on ``device`` on first use (`images_dev`) or sharded
    over the ranks of a mesh (`shard_over`).  A batch is image indices and
    in-bounds crop corners from a numpy `RandomState` (`sample_coords`, the
    JAX package's draws), one gather, and `prepare_batch_torch` from the
    generator.
    ``key_counter`` counts batches, as the JAX package's per-batch key
    does.  Raises ValueError when the padded stack would exceed
    ``max_bytes``, checked while decoding (the trainer then takes
    `DenoisePatchPipeline`).
    """

    def __init__(self, dataset, patch: int, algorithm: NoiseAlgorithm,
                 noise_style: Optional[str], seed: int = 0,
                 noise_input: bool = False, max_bytes: int = 4 << 30,
                 device: torch.device | str = "cpu"):
        self.patch = patch
        self.algorithm = algorithm
        self.noise_style = noise_style
        self.noise_input = noise_input
        self.device = torch.device(device)

        n_imgs = len(dataset)
        if n_imgs == 0:
            raise ValueError("empty dataset")
        # A lower bound of the padded stack is checked as it grows, so an
        # over-budget dataset is refused at its first oversize image.
        imgs = []
        hmax = wmax = patch
        for i in range(n_imgs):
            im = np.asarray(dataset[i], np.float32)
            h, w = im.shape[:2]
            if h < patch or w < patch:
                im = np.pad(im, ((0, max(0, patch - h)),
                                 (0, max(0, patch - w))), mode="reflect")
                h, w = im.shape[:2]
            imgs.append(im)
            hmax, wmax = max(hmax, h), max(wmax, w)
            nbytes = n_imgs * hmax * wmax * 4
            if nbytes > max_bytes:
                raise ValueError(
                    f"image stack (>= {nbytes / 2**30:.1f} GiB padded) "
                    f"exceeds the device data-plane budget "
                    f"({max_bytes / 2**30:.1f} GiB)")
        self.heights = np.array([im.shape[0] for im in imgs], np.int32)
        self.widths = np.array([im.shape[1] for im in imgs], np.int32)
        self.stack = StackOnDevice(PaddedStack(imgs), self.device)

        self.rng = np.random.RandomState(seed)
        self._gen_seed = seed ^ 0x5EED
        self._key_counter = 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            self._gen_seed)

    def sample_coords(self, shape):
        """Image indices and in-bounds crop corners of ``shape`` ((B,) or
        (K, B)): the host's only per-batch work."""
        flat = self.rng.randint(len(self.heights), size=shape).astype(np.int32)
        ry = self.rng.random_sample(shape)
        rx = self.rng.random_sample(shape)
        ys = (ry * (self.heights[flat] - self.patch + 1)).astype(np.int32)
        xs = (rx * (self.widths[flat] - self.patch + 1)).astype(np.int32)
        return flat, ys, xs

    @property
    def images_dev(self) -> torch.Tensor:
        return self.stack.images_dev

    def shard_over(self, mesh) -> None:
        """Shard the stack over the mesh's ranks (`StackOnDevice.shard_over`;
        JAX `patches.py:180-188`)."""
        self.stack.shard_over(mesh)

    def gather(self, flat, ys, xs) -> torch.Tensor:
        """(B, patch, patch) crops with corners (ys, xs) of images
        ``flat``: one gather from the stack (and a sum over the ranks of a
        mesh)."""
        return self.stack.crops(flat, ys, xs, None, self.patch,
                                centered=False)

    def batch(self, batch_size: int) -> Dict[str, torch.Tensor]:
        flat, ys, xs = self.sample_coords((batch_size,))
        self._key_counter += 1
        return prepare_batch_torch(
            self.gather(flat, ys, xs), self.algorithm, self.noise_style,
            self.generator, training=True, noise_input=self.noise_input)

    def count_batches(self, k: int) -> None:
        """Count ``k`` batches that a training chunk drew from ``generator``
        itself (`steps.make_denoise_scan`), so ``key_counter`` still counts
        every batch; the JAX scan leaves its counter alone, as it draws
        from the trainer's key."""
        self._key_counter += k

    def _reseed(self) -> None:
        """The generator for a position known only by its batch count."""
        self.generator.manual_seed((self._gen_seed << 32) | self._key_counter)

    def state_dict(self):
        """Crop RNG, batch count and the generator (resumable data plane);
        the JAX package reads the first two."""
        return {"rng_state": self.rng.get_state(),
                "key_counter": self._key_counter,
                "torch_generator": {
                    "device": self.device.type,
                    "state": self.generator.get_state().numpy()}}

    def load_state_dict(self, sd) -> None:
        """A JAX-written state has no generator state: the generator is
        reseeded from the batch count, so the noise and UPS draws after the
        resume differ from an uninterrupted JAX run's (they could not equal
        them anyway)."""
        self.rng.set_state(sd["rng_state"])
        self._key_counter = int(sd.get("key_counter", 0))
        saved = sd.get("torch_generator")
        if saved is not None and saved["device"] == self.device.type:
            self.generator.set_state(
                torch.from_numpy(np.asarray(saved["state"])))
            return
        if saved is not None:
            logger.warning(
                "data plane's generator state is for %s, this run is on %s: "
                "reseeded from the batch count", saved["device"],
                self.device.type)
        self._reseed()


class UnlabeledEvalDataset:
    """The `test_item` contract of `MicrographDataset` over a folder dataset
    without coordinates, so the evaluator's dense pass and artifact dumps
    work on unlabelled data (`spr_pick_tpu/data/patches.py:227-258`)."""

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
