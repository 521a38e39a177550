"""Configuration defaults and inference.

The PyTorch port's copy of `spr_pick_tpu/cfg.py`, keyed by the port's own
enums: the same default values, pipeline/blindspot inference rules and
config-name scheme (behavioural parity with `spr_pick/cfg.py:10-202`).
COMPUTE_DTYPE keeps its "bf16" default: the port's convs run in bf16 on
the card as well.
"""

from __future__ import annotations

import os
from typing import Dict

from spr_pick_tpu_torch.params import (
    ConfigValue as CV,
    DatasetType,
    NoiseAlgorithm,
    Pipeline,
)

# Re-export under the parity name as well.
ConfigValue = CV

DEFAULT_RUN_DIR = "hi_runs"

# Reference defaults (spr_pick/cfg.py:10-43), grouped by concern.
_TRAINING_DEFAULTS = {
    CV.ITERATIONS: 200000,
    CV.TRAIN_MINIBATCH_SIZE: 16,
    CV.TRAIN_PATCH_SIZE: 64,
    # The reference STORES 1e-5 here but its trainer ignores it and
    # hardcodes 1e-4 (spr_pick/train.py:441) — the stored value is dead
    # surface.  Here the config is the source of truth at the same
    # effective default, which makes --lr actually work.
    CV.LEARNING_RATE: 1e-4,
    CV.JOINT_LR: 1e-5,
    CV.LR_RAMPDOWN_FRACTION: 0.7,
    CV.LR_RAMPUP_FRACTION: 0.2,
    CV.ALPHA: 0.8,
    CV.TAU: 0.01,
    CV.DETECTLOSS: None,
}
_INTERVAL_DEFAULTS = {
    CV.EVAL_INTERVAL: 3200,
    CV.PRINT_INTERVAL: 1280,
    CV.SNAPSHOT_INTERVAL: 3200,
}
_DATA_DEFAULTS = {
    CV.IMAGE_CHANNELS: 1,
    CV.DATALOADER_WORKERS: 4,
    CV.PIN_DATA_MEMORY: False,
    CV.DIAGONAL_COVARIANCE: False,
    CV.NOISE_STYLE: None,
    CV.TRAIN_DATA_PATH: None,
    CV.TRAIN_GT_PATH: None,
    CV.TRAIN_LABEL_PATH: None,
    CV.TRAIN_DATASET_TYPE: None,
    CV.TEST_DATA_PATH: None,
    CV.TEST_LABEL_PATH: None,
    CV.TEST_GT_PATH: None,
    CV.TEST_DATASET_TYPE: None,
    # Add the synthetic noise to the INPUT as well as the reference image
    # (for clean benchmark datasets; the reference carries this switch in
    # NoisyDataset but ships it disabled — noise_wrapper.py:123).
    CV.NOISE_INPUT: False,
}
_EVAL_DEFAULTS = {
    CV.TEST_MINIBATCH_SIZE: 1,
    CV.NUM_EVAL: 1,
    CV.NMS: 15,
    CV.BB: 24,
    # Seed NMS with a find_contamination() suppression mask (the reference
    # declares this hook but its active path passes an empty set;
    # algorithms.py:59-64, train.py:582-583).
    CV.EXCLUDE_CONTAM: False,
}
# TPU-native additions (not present in the reference).
_TPU_DEFAULTS = {
    CV.MESH_SHAPE: None,       # data-parallel mesh size (None = all devices)
    CV.DEVICE_DATA_PATH: True,  # keep the micrograph stack resident in HBM
    CV.MAX_PEAKS: 2048,         # static cap for on-device NMS output
    CV.SEED: 0,
    # bf16 compute on the conv path; losses/NLL math stay float32.
    CV.COMPUTE_DTYPE: "bf16",
}


def base() -> Dict:
    cfg: Dict = {}
    for group in (
        _TRAINING_DEFAULTS,
        _INTERVAL_DEFAULTS,
        _DATA_DEFAULTS,
        _EVAL_DEFAULTS,
        _TPU_DEFAULTS,
    ):
        cfg.update(group)
    return cfg


def _dataset_type_for(path: str) -> DatasetType:
    if os.path.isdir(path):
        return DatasetType.FOLDER
    if path.endswith(".txt"):
        return DatasetType.TXT
    return DatasetType.HDF5


def infer_datasets(cfg: Dict):
    """Infer dataset type (folder / .txt manifest / hdf5) from each path.

    Parity: spr_pick/cfg.py:105-127.
    """
    for path_key, type_key in (
        (CV.TRAIN_DATA_PATH, CV.TRAIN_DATASET_TYPE),
        (CV.TEST_DATA_PATH, CV.TEST_DATASET_TYPE),
    ):
        path = cfg.get(path_key)
        if path is not None and cfg.get(type_key) is None:
            cfg[type_key] = _dataset_type_for(path)


def test_length(cfg: Dict) -> int:
    """Micrographs an evaluation visits (the sampler wraps around)."""
    return cfg[CV.NUM_EVAL]


# Algorithm -> (pipeline, blindspot) table (spr_pick/cfg.py:146-174).
_ALGORITHM_TABLE = {
    NoiseAlgorithm.SELFSUPERVISED_DENOISING: (Pipeline.SSDN, True),
    NoiseAlgorithm.SELFSUPERVISED_DENOISING_MEAN_ONLY: (Pipeline.MSE, True),
    NoiseAlgorithm.NOISE_TO_NOISE: (Pipeline.MSE, False),
    NoiseAlgorithm.NOISE_TO_CLEAN: (Pipeline.MSE, False),
    NoiseAlgorithm.NOISE_TO_VOID: (Pipeline.MASK_MSE, False),
}


def infer_pipeline(algorithm: NoiseAlgorithm) -> Pipeline:
    try:
        return _ALGORITHM_TABLE[algorithm][0]
    except KeyError:
        raise NotImplementedError("Algorithm does not have a default pipeline.")


def infer_blindspot(algorithm: NoiseAlgorithm) -> bool:
    try:
        return _ALGORITHM_TABLE[algorithm][1]
    except KeyError:
        raise NotImplementedError("Not known if algorithm requires blindspot.")


def infer(cfg: Dict, model_only: bool = False) -> Dict:
    if cfg.get(CV.PIPELINE) is None:
        cfg[CV.PIPELINE] = infer_pipeline(cfg[CV.ALGORITHM])
    if cfg.get(CV.BLINDSPOT) is None:
        cfg[CV.BLINDSPOT] = infer_blindspot(cfg[CV.ALGORITHM])
    if not model_only:
        infer_datasets(cfg)
    return cfg


def config_name(cfg: Dict) -> str:
    """`{algo}[-{pipeline}_pipeline]-{noise_style}` (spr_pick/cfg.py:188-202)."""
    cfg = infer(cfg)
    parts = [cfg[CV.ALGORITHM].value]
    if cfg[CV.PIPELINE] != infer_pipeline(cfg[CV.ALGORITHM]):
        parts.append(cfg[CV.PIPELINE].value + "_pipeline")
    parts.append(cfg[CV.NOISE_STYLE])
    return "-".join(parts)
