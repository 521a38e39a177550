"""Enumerations shared across the framework.

The enum *surface* (member names, and the string values used in CLIs,
config names and checkpoints) mirrors the reference (`spr_pick/params.py`)
so configs and run names translate one-to-one.  Members whose concrete
values never leave the process (ConfigValue / StateValue / ...) are built
with the functional Enum API from name tables.

This is the PyTorch port's own copy of `spr_pick_tpu/params.py`: the same
classes, member names and values, so a checkpoint written by the JAX
package maps onto these members one-to-one (utils/checkpoint.py) without
the port importing that package.
"""

from __future__ import annotations

from enum import Enum


class NoiseAlgorithm(Enum):
    """Training algorithm selector (CLI `--algorithm`)."""

    SELFSUPERVISED_DENOISING = "ssdn"
    SELFSUPERVISED_DENOISING_MEAN_ONLY = "ssdn_u_only"
    NOISE_TO_NOISE = "n2n"
    NOISE_TO_CLEAN = "n2c"
    NOISE_TO_VOID = "n2v"


class NoiseValue(Enum):
    """How the noise sigma is obtained (CLI `--noise_value`)."""

    UNKNOWN_CONSTANT = "const"
    UNKNOWN_VARIABLE = "var"
    KNOWN = "known"


class Loss(Enum):
    FOCAL = "focal"
    MSE = "mse"


class Pipeline(Enum):
    """Which loss pipeline the engine dispatches to."""

    MSE = "mse"
    SSDN = "ssdn"
    MASK_MSE = "mask_mse"


class Blindspot(Enum):
    ENABLED = "blindspot"
    DISABLED = "normal"


def _auto_enum(name: str, members: str) -> type:
    return Enum(name, [(m, i) for i, m in enumerate(members.split(), 1)])


# Configuration keys.  The first block is the reference surface; the
# trailing TPU-native block (MESH_SHAPE..COMPUTE_DTYPE) is new here.
ConfigValue = _auto_enum(
    "ConfigValue",
    """
    INFER_CFG ALGORITHM BLINDSPOT PIPELINE IMAGE_CHANNELS
    NOISE_STYLE BB LEARNING_RATE LR_RAMPUP_FRACTION LR_RAMPDOWN_FRACTION
    DETECTLOSS NOISE_VALUE DIAGONAL_COVARIANCE NMS
    EVAL_INTERVAL PRINT_INTERVAL SNAPSHOT_INTERVAL ITERATIONS
    DATALOADER_WORKERS
    TRAIN_DATASET_NAME TRAIN_DATASET_TYPE TRAIN_GT_PATH TRAIN_DATA_PATH
    TRAIN_LABEL_PATH TRAIN_PATCH_SIZE TRAIN_MINIBATCH_SIZE
    TEST_GT_PATH TEST_DATASET_NAME TEST_DATASET_TYPE TEST_DATA_PATH
    TEST_LABEL_PATH TEST_MINIBATCH_SIZE
    PIN_DATA_MEMORY JOINT_LR ALPHA FRACTION NUM_EVAL TAU
    MESH_SHAPE DEVICE_DATA_PATH MAX_PEAKS SEED COMPUTE_DTYPE
    EXCLUDE_CONTAM NOISE_INPUT
    """,
)

DatasetType = _auto_enum("DatasetType", "HDF5 FOLDER TXT")

StateValue = _auto_enum(
    "StateValue", "INITIALISED MODE ITERATION REFERENCE HISTORY"
)

HistoryValue = _auto_enum("HistoryValue", "TRAIN EVAL TIMINGS")


class PipelineOutput(Enum):
    """Pipeline output keys.  Totally ordered by name so dicts keyed by this
    enum are valid JAX pytrees (jit sorts dictionary keys).  String values
    are the metric/artifact names the reference uses."""

    def __lt__(self, other):
        if isinstance(other, PipelineOutput):
            return self.name < other.name
        return NotImplemented

    INPUTS = "inputs"
    LOSS = "loss"
    DETECT_LOSS = "det_loss"
    DENOISE_LOSS = "denoise_loss"
    IMG_DENOISED = "out"
    IMG_MU = "out_mu"
    NOISE_STD_DEV = "noise_std"
    MODEL_STD_DEV = "model_std"
    TARGET = "target"
    GT = "ground_truth"
    AUG_LOSS = "aug_loss"
    DETECT = "detect"
