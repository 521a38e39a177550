"""The weight carrier: JAX checkpoint trees <-> the port's module state.

A checkpoint holds two numpy trees in the flax layout
(`spr_pick_tpu/denoiser.py:split_trainable`):

  trainable = {"model": params, "sigma": params?, "l_params": {...}?}
  static    = {"model": batch_stats, "sigma": batch_stats?}

The port's modules carry the flax submodule names, so a flax path maps to a
``state_dict`` key by joining with dots and renaming the leaf:

  conv ``kernel`` (H, W, I, O)      -> ``weight`` (O, I, H, W), a transpose
                                       (3, 2, 0, 1) with no flip
  BatchNorm ``scale`` / ``bias``    -> ``weight`` / ``bias``
  static ``mean`` / ``var``         -> ``running_mean`` / ``running_var``
  ``l_params/estimated_sigma``      -> kept as it is

`flax_to_state` and `state_to_flax` are exact inverses on these trees.
`named_to_flax` and `flax_to_named` apply the same transforms to any
tensors aligned with the trainable parameters, such as Adam's moments.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_GROUPS = ("model", "sigma")
_STATIC_LEAF = {"mean": "running_mean", "var": "running_var"}
_STATIC_LEAF_BACK = {v: k for k, v in _STATIC_LEAF.items()}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _set(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def flax_to_state(trainable: Dict, static: Dict) -> Dict[str, Dict]:
    """Numpy flax trees -> {"model": state_dict, "sigma": state_dict?,
    "l_params": {"estimated_sigma": tensor}?} of float32 CPU tensors."""
    states: Dict[str, Dict] = {}
    for group in _GROUPS:
        if group not in trainable:
            continue
        sd = states.setdefault(group, {})
        for path, value in _flatten(trainable[group]):
            a = np.asarray(value)
            module, leaf = ".".join(path[:-1]), path[-1]
            if leaf == "kernel":
                sd[f"{module}.weight"] = _tensor(a.transpose(3, 2, 0, 1))
            elif leaf == "scale":
                sd[f"{module}.weight"] = _tensor(a)
            elif leaf == "bias":
                sd[f"{module}.bias"] = _tensor(a)
            else:
                raise KeyError(f"unexpected parameter {group}/{'/'.join(path)}")
        for path, value in _flatten(static.get(group, {})):
            module, leaf = ".".join(path[:-1]), path[-1]
            sd[f"{module}.{_STATIC_LEAF[leaf]}"] = _tensor(value)
            sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    if "l_params" in trainable:
        states["l_params"] = {
            k: _tensor(v) for k, v in trainable["l_params"].items()
        }
    return states


def state_to_flax(states: Dict[str, Dict]) -> Tuple[Dict, Dict]:
    """Inverse of `flax_to_state`: -> (trainable, static) numpy trees."""
    trainable: Dict = {}
    static: Dict = {}
    for group in _GROUPS:
        if group not in states:
            continue
        for key, t in states[group].items():
            *module, leaf = key.split(".")
            a = t.detach().cpu().numpy()
            if leaf == "num_batches_tracked":
                continue
            if leaf in _STATIC_LEAF_BACK:
                _set(static, (group, *module, _STATIC_LEAF_BACK[leaf]), a)
            elif leaf == "weight" and a.ndim == 4:
                _set(trainable, (group, *module, "kernel"),
                     np.ascontiguousarray(a.transpose(2, 3, 1, 0)))
            elif leaf == "weight":
                _set(trainable, (group, *module, "scale"), a)
            else:
                _set(trainable, (group, *module, leaf), a)
    if "l_params" in states:
        trainable["l_params"] = {
            k: v.detach().cpu().numpy() for k, v in states["l_params"].items()
        }
    return trainable, static


def named_to_flax(named) -> Dict:
    """(group, state key, tensor) triples (`Denoiser.named_trainable`) ->
    one numpy tree in the flax trainable layout."""
    states: Dict[str, Dict] = {}
    for group, key, t in named:
        states.setdefault(group, {})[key] = t
    return state_to_flax(states)[0]


def flax_to_named(tree: Dict, named) -> list:
    """Inverse of `named_to_flax`: the tree's float32 CPU tensors in the
    order of ``named``."""
    states = flax_to_state(tree, {})
    return [states[group][key] for group, key, _ in named]
