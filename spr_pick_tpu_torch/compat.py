"""Reference (PyTorch) checkpoints: load them, and write them.

The port's copy of `spr_pick_tpu/compat.py`.  A reference checkpoint is a
``torch.save`` of `spr_pick`'s denoiser ``state_dict`` (``.wt``, with its
cfg embedded) or of ``{"denoiser": state_dict + cfg, "state": ...}``
(``.training``).  Its tensors are already torch OIHW, the port's layout, so
conversion is names only, reference key -> this package's ``state_dict``
key:

  models.denoiser_model.denoise_branch.<block>      -> model denoise_branch.<conv>.conv
  models.denoiser_model.detector.m                  -> model detector.input_bn
  ...detector.detector.features.features.<i>.<leaf> -> model detector.features.layer<i>.<leaf>
  ...detector.detector.classifier                   -> model detector.classifier.classifier
  models.sigma_estimation_model.<block>             -> sigma <conv>.conv (3 levels)
  l_params.estimated_sigma                          -> l_params estimated_sigma

with ``<block> -> <conv>`` from `UNET5`/`UNET3` and BatchNorm's
``weight/bias/running_mean/running_var`` kept as they are.

Files are read with ``torch.load(..., pickle_module=utils.ref_pickle)``:
the reference package is never imported (`utils/ref_pickle.py` maps its
enums by value onto this package's).  `load_reference_checkpoint` returns
the dict `utils.checkpoint.load` returns for the port's own files, so the
Picker, the evaluator, ``eval -m``, ``pick`` and ``train resume`` take a
reference file as they are.  Not carried over, as in the JAX package: the
reference optimizer state and its torch RNG (a resumed converted
`.training` starts Adam fresh).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import weights
from spr_pick_tpu_torch.params import ConfigValue, StateValue
from spr_pick_tpu_torch.utils import ref_pickle
from spr_pick_tpu_torch.utils.checkpoint import (TRAINING_FORMAT, WT_FORMAT,
                                                CheckpointError)

logger = logging.getLogger("compat")

# U-Net conv names by depth (spr_pick_tpu/compat.py:38-77): the 5-level
# denoise branch, and the 3-level sigma estimator, whose decoder runs
# blocks 5, 2, 1 (decode_block_3 exists in the reference but is dead).
UNET5 = {
    "encode_block_1.0": "enc1_conv0",
    "encode_block_1.2": "enc1_conv1",
    "encode_block_2.0": "enc2_conv0",
    "encode_block_3.0": "enc3_conv0",
    "encode_block_4.0": "enc4_conv0",
    "encode_block_5.0": "enc5_conv0",
    "encode_block_6.0": "enc_bottom_conv0",
    "decode_block_5.0": "dec0_conv0",
    "decode_block_5.2": "dec0_conv1",
    "decode_block_4.0": "dec1_conv0",
    "decode_block_4.2": "dec1_conv1",
    "decode_block_3.0": "dec2_conv0",
    "decode_block_3.2": "dec2_conv1",
    "decode_block_2.0": "dec3_conv0",
    "decode_block_2.2": "dec3_conv1",
    "decode_block_1.0": "dec_final_conv0",
    "decode_block_1.2": "dec_final_conv1",
    "output_block.0": "out_block_conv0",
    "output_block.2": "out_block_conv1",
    "output_conv": "out_conv",
}
UNET3 = {
    "encode_block_1.0": "enc1_conv0",
    "encode_block_1.2": "enc1_conv1",
    "encode_block_2.0": "enc2_conv0",
    "encode_block_3.0": "enc3_conv0",
    "encode_block_6.0": "enc_bottom_conv0",
    "decode_block_5.0": "dec0_conv0",
    "decode_block_5.2": "dec0_conv1",
    "decode_block_2.0": "dec1_conv0",
    "decode_block_2.2": "dec1_conv1",
    "decode_block_1.0": "dec_final_conv0",
    "decode_block_1.2": "dec_final_conv1",
    "output_block.0": "out_block_conv0",
    "output_block.2": "out_block_conv1",
    "output_conv": "out_conv",
}

MODEL = "models.denoiser_model."
SIGMA = "models.sigma_estimation_model."
DETECTOR_BN = MODEL + "detector.m."
FEATURES = MODEL + "detector.detector.features.features."
CLASSIFIER = MODEL + "detector.detector.classifier."
EST_SIGMA = "l_params.estimated_sigma"
# The ResNet8 leaves the JAX converter carries (compat.py:110-135).
_RESNET_LEAVES = tuple(
    f"{m}.{leaf}" for m in ("conv", "conv0", "conv1", "proj")
    for leaf in ("weight", "bias")
) + tuple(
    f"{m}.{leaf}" for m in ("bn", "bn0", "bn1")
    for leaf in ("weight", "bias", "running_mean", "running_var")
)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_TORCH_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu().clone() if isinstance(v, torch.Tensor) \
        else torch.tensor(np.asarray(v))


def convert_reference_state_dict(sd: Dict[str, Any]) -> Dict[str, Dict]:
    """Reference ``Denoiser.state_dict()`` -> {"model": state_dict,
    "sigma": state_dict?, "l_params": {"estimated_sigma": t}?} in this
    package's module names (`weights.flax_to_state`'s layout), float CPU
    tensors.  Non-tensor entries (the embedded cfg) are ignored."""
    sd = {k: v for k, v in sd.items()
          if isinstance(v, (torch.Tensor, np.ndarray))}
    model: Dict[str, torch.Tensor] = {}
    for ref, ours in UNET5.items():
        for leaf in ("weight", "bias"):
            key = f"{MODEL}denoise_branch.{ref}.{leaf}"
            if key in sd:
                model[f"denoise_branch.{ours}.conv.{leaf}"] = _tensor(sd[key])
    if DETECTOR_BN + "weight" in sd:
        for leaf in _BN_LEAVES:
            model[f"detector.input_bn.{leaf}"] = _tensor(sd[DETECTOR_BN + leaf])
        for i in range(5):
            for leaf in _RESNET_LEAVES:
                key = f"{FEATURES}{i}.{leaf}"
                if key in sd:
                    model[f"detector.features.layer{i}.{leaf}"] = \
                        _tensor(sd[key])
        for leaf in ("weight", "bias"):
            model[f"detector.classifier.classifier.{leaf}"] = \
                _tensor(sd[CLASSIFIER + leaf])
    states = {"model": model}
    if SIGMA + "encode_block_1.0.weight" in sd:
        sigma = {}
        for ref, ours in UNET3.items():
            for leaf in ("weight", "bias"):
                key = f"{SIGMA}{ref}.{leaf}"
                if key in sd:
                    sigma[f"{ours}.conv.{leaf}"] = _tensor(sd[key])
        states["sigma"] = sigma
    if EST_SIGMA in sd:
        states["l_params"] = {"estimated_sigma": _tensor(sd[EST_SIGMA])}
    return states


def trainable_static_from_reference(sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """The (trainable, static) numpy trees in the flax layout that the
    port's checkpoint dicts carry (what the JAX package's converter gives:
    a model without BatchNorm has an empty static model tree)."""
    trainable, static = weights.state_to_flax(convert_reference_state_dict(sd))
    static.setdefault("model", {})
    return trainable, static


def convert_cfg(ref_cfg: Dict) -> Dict:
    """A reference cfg, as `utils/ref_pickle.py` unpickles it (keys and
    enum values already this package's members, or `Unplaced`) -> this
    package's cfg: `cfg.base()` updated with every placed key.  A key or
    value the enum table cannot place is dropped with a warning naming it.
    A stored learning rate of 1e-5 becomes 1e-4: the reference stores its
    dead 1e-5 default but trains at a hardcoded 1e-4
    (spr_pick_tpu/compat.py:222-228)."""
    out = cfg_mod.base()
    for key, value in (ref_cfg or {}).items():
        if isinstance(key, ref_pickle.Unplaced):
            logger.warning("reference cfg key %s(%r) is not in the enum "
                           "table; dropped", key.enum, key.value)
            continue
        if isinstance(value, ref_pickle.Unplaced):
            logger.warning("reference cfg value %s(%r) of %s is not in the "
                           "enum table; dropped", value.enum, value.value,
                           getattr(key, "name", key))
            continue
        if not isinstance(key, ConfigValue):
            continue
        if key == ConfigValue.LEARNING_RATE and value == 1e-5:
            value = 1e-4
        out[key] = value
    return out


def _iteration(state: Dict) -> int:
    for key, value in (state or {}).items():
        if key == StateValue.ITERATION:
            return int(value)
    return 0


def _read(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=ref_pickle)
    except CheckpointError:
        raise
    except Exception as exc:
        raise CheckpointError(
            f"{path!r} is not a readable PyTorch checkpoint "
            f"({type(exc).__name__}: {exc})") from exc


def load_reference_checkpoint(path: str, mode: str = "joint") -> Dict:
    """Read a reference `.training`/`.wt` into the dict layout of
    `utils.checkpoint.load`: ``format``, ``cfg``, ``mode``, ``trainable``,
    ``static`` and, for a `.training`, ``iteration`` (the state's
    ITERATION), ``opt_state=None``, ``rng_key=None``, ``extra={}``.

    ``mode`` is the mode to load in (the files do not record one); a file
    without detector weights loads in "denoise" mode, with a warning, when
    "joint" was asked for (spr_pick_tpu/compat.py:372-383)."""
    state = _read(path)
    if not isinstance(state, dict):
        raise CheckpointError(f"{path!r}: a PyTorch checkpoint that is not a "
                              f"state dict ({type(state).__name__})")
    training = "denoiser" in state
    sd = state["denoiser"] if training else state
    trainable, static = trainable_static_from_reference(sd)
    if "model" not in trainable:
        raise CheckpointError(f"{path!r} holds no reference denoiser weights")
    if mode == "joint" and "detector" not in trainable["model"]:
        logger.warning("%s has no detector weights; loading in 'denoise' "
                       "mode instead of 'joint'", path)
        mode = "denoise"
    out = {
        "format": TRAINING_FORMAT if training else WT_FORMAT,
        "cfg": convert_cfg(sd.get("cfg")),
        "mode": mode,
        "trainable": trainable,
        "static": static,
    }
    if training:
        out.update(iteration=_iteration(state.get("state")), opt_state=None,
                   rng_key=None, extra={})
    return out


def is_legacy_torch_magic(obj) -> bool:
    """Whether ``obj`` is the first record of a legacy (non-zip)
    ``torch.save`` stream."""
    return type(obj) is int and obj == _TORCH_LEGACY_MAGIC


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _reference_names() -> Dict[str, Tuple[str, str]]:
    """(group, this package's key) -> reference key, for every name the
    converter maps."""
    names = {}
    for ref, ours in UNET5.items():
        for leaf in ("weight", "bias"):
            names[("model", f"denoise_branch.{ours}.conv.{leaf}")] = \
                f"{MODEL}denoise_branch.{ref}.{leaf}"
    for leaf in _BN_LEAVES:
        names[("model", f"detector.input_bn.{leaf}")] = DETECTOR_BN + leaf
    for i in range(5):
        for leaf in _RESNET_LEAVES:
            names[("model", f"detector.features.layer{i}.{leaf}")] = \
                f"{FEATURES}{i}.{leaf}"
    for leaf in ("weight", "bias"):
        names[("model", f"detector.classifier.classifier.{leaf}")] = \
            CLASSIFIER + leaf
    for ref, ours in UNET3.items():
        for leaf in ("weight", "bias"):
            names[("sigma", f"{ours}.conv.{leaf}")] = f"{SIGMA}{ref}.{leaf}"
    names[("l_params", "estimated_sigma")] = EST_SIGMA
    return names


def reference_state_dict(trainable: Dict, static: Dict) -> Dict[str, Any]:
    """Numpy flax trees (a port checkpoint's) -> the reference denoiser's
    ``state_dict`` names and OIHW tensors: the inverse of
    `convert_reference_state_dict`."""
    names = _reference_names()
    sd: Dict[str, Any] = {}
    for group, state in weights.flax_to_state(trainable, static).items():
        for key, t in state.items():
            if key.endswith("num_batches_tracked"):
                continue
            sd[names[(group, key)]] = t
    return sd


def reference_cfg(cfg: Dict) -> Dict:
    """This package's cfg restricted to the keys the reference has, for
    writing under its names."""
    out = {}
    for key, value in cfg.items():
        try:
            ref_pickle.reference_value(key)
        except KeyError:
            continue
        out[key] = value
    return out


def save_reference_checkpoint(path: str, trainable: Dict, static: Dict,
                              cfg: Dict, iteration: Optional[int] = None,
                              legacy: bool = False) -> None:
    """Write the reference's format with ``torch.save``: a `.wt` (flat
    ``state_dict`` + ``cfg``), or a `.training` (``{"denoiser": ...,
    "state": {ITERATION: iteration}}``) when ``iteration`` is given.  The
    cfg's enums are pickled as ``spr_pick.params.<Enum>`` with the
    reference's values; ``legacy`` writes torch's non-zip stream."""
    sd = reference_state_dict(trainable, static)
    sd["cfg"] = reference_cfg(cfg)
    obj = sd if iteration is None else {
        "denoiser": sd, "state": {StateValue.ITERATION: int(iteration)}}
    torch.save(obj, path, pickle_module=ref_pickle,
               _use_new_zipfile_serialization=not legacy)
