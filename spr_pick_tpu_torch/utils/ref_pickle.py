"""The pickle module that reads and writes reference PyTorch checkpoints.

A reference checkpoint (`spr_pick`'s `.training`/`.wt`, written by
``torch.save``) pickles its cfg and state under the reference package's own
globals: ``spr_pick.params.<Enum>`` members, and ``spr_pick.utils.*``
history objects in a `.training`'s state.  This module is what
`compat.py` hands ``torch.load``/``torch.save`` as ``pickle_module``
(torch's loaders subclass ``pickle_module.Unpickler``, so every global
that is not a storage reaches `Unpickler.find_class` here), so neither the
reference package nor its dependencies are imported:

  * ``spr_pick.params.<Enum>`` -> this package's enum of that name,
    member by exact VALUE (an enum pickles as ``(cls, (value,))``) through
    `REFERENCE_VALUES`; a value the table cannot place comes back as an
    `Unplaced` marker, which `compat.convert_cfg` drops with a warning;
  * any other ``spr_pick.*`` global -> an inert placeholder class that
    accepts any construction and state and is never read;
  * torch's tensor and parameter rebuilds, dtypes and sizes, numpy's array
    reconstructors, ``collections.OrderedDict``/``defaultdict`` and a few
    plain builtin types;
  * anything else raises `CheckpointError`.

`Pickler` writes the other way: this package's enum members under the
reference's global names and values, for `compat.save_reference_checkpoint`.
"""

from __future__ import annotations

import enum
import pickle
from typing import Any, Dict, NamedTuple, Tuple

import torch

from spr_pick_tpu_torch import params
from spr_pick_tpu_torch.utils.checkpoint import (CheckpointError,
                                                is_numpy_global)

REF_PARAMS = "spr_pick.params"


def _numbered(names: str, start: int = 1) -> Dict[Any, str]:
    return {i: n for i, n in enumerate(names.split(), start)}


# The reference's `auto()` enums, value -> member name.  Its ConfigValue
# declares ``JOINT_LR = 1e-5`` between two runs of ``auto()``
# (spr_pick/params.py:72; SURVEY.md §7.4), so the members after it take
# values that depend on the Python that pickled the file: up to 3.10
# ``auto()`` adds 1 to the LAST value (1e-5 + 1, then + 1 again); from
# 3.11 it adds 1 to the LARGEST (34, 35, ...).  Both runs are listed; no
# value of one collides with a value of the other or of the members before
# JOINT_LR.  The member order is the reference surface that
# `spr_pick_tpu/params.py` declares (its first block).
_CONFIG_BEFORE_JOINT_LR = _numbered("""
    INFER_CFG ALGORITHM BLINDSPOT PIPELINE IMAGE_CHANNELS
    NOISE_STYLE BB LEARNING_RATE LR_RAMPUP_FRACTION LR_RAMPDOWN_FRACTION
    DETECTLOSS NOISE_VALUE DIAGONAL_COVARIANCE NMS
    EVAL_INTERVAL PRINT_INTERVAL SNAPSHOT_INTERVAL ITERATIONS
    DATALOADER_WORKERS
    TRAIN_DATASET_NAME TRAIN_DATASET_TYPE TRAIN_GT_PATH TRAIN_DATA_PATH
    TRAIN_LABEL_PATH TRAIN_PATCH_SIZE TRAIN_MINIBATCH_SIZE
    TEST_GT_PATH TEST_DATASET_NAME TEST_DATASET_TYPE TEST_DATA_PATH
    TEST_LABEL_PATH TEST_MINIBATCH_SIZE
    PIN_DATA_MEMORY
""")
_JOINT_LR = 1e-5
_CONFIG_AFTER_JOINT_LR = ("ALPHA", "FRACTION", "NUM_EVAL", "TAU")


def _config_values() -> Dict[Any, str]:
    table = dict(_CONFIG_BEFORE_JOINT_LR)
    table[_JOINT_LR] = "JOINT_LR"
    largest = max(_CONFIG_BEFORE_JOINT_LR)
    last = _JOINT_LR
    for i, name in enumerate(_CONFIG_AFTER_JOINT_LR, 1):
        last = last + 1          # Python <= 3.10: the last value + 1
        table[last] = name
        table[largest + i] = name  # Python >= 3.11: the largest value + 1
    return table


def _string_values(cls) -> Dict[Any, str]:
    # The port's copies of the reference's string-valued enums carry its
    # values verbatim (params.py).
    return {m.value: m.name for m in cls}


REFERENCE_VALUES: Dict[str, Dict[Any, str]] = {
    "ConfigValue": _config_values(),
    "DatasetType": _numbered("HDF5 FOLDER TXT"),
    "StateValue": _numbered("INITIALISED MODE ITERATION REFERENCE HISTORY"),
    "HistoryValue": _numbered("TRAIN EVAL TIMINGS"),
    "NoiseAlgorithm": _string_values(params.NoiseAlgorithm),
    "NoiseValue": _string_values(params.NoiseValue),
    "Pipeline": _string_values(params.Pipeline),
    "Blindspot": _string_values(params.Blindspot),
    "Loss": _string_values(params.Loss),
    "PipelineOutput": _string_values(params.PipelineOutput),
}


def _write_values(table: Dict[Any, str]) -> Dict[str, Any]:
    """member name -> the value the writer stores: where a member has two
    (ConfigValue after JOINT_LR), the larger, which is what `auto()` gives
    on Python 3.11 and later."""
    out: Dict[str, Any] = {}
    for value, name in table.items():
        if name not in out or value > out[name]:
            out[name] = value
    return out


_WRITE_VALUES = {name: _write_values(table)
                 for name, table in REFERENCE_VALUES.items()}


class Unplaced(NamedTuple):
    """A reference enum value that `REFERENCE_VALUES` has no member for."""

    enum: str
    value: Any


class _EnumByValue:
    """What ``spr_pick.params.<Enum>`` unpickles to: called with the stored
    value, it returns this package's member of that name, or `Unplaced`."""

    def __init__(self, name: str):
        self.name = name
        self.table = REFERENCE_VALUES[name]
        self.cls = getattr(params, name)

    def __call__(self, value):
        member = self.table.get(value)
        if member is None or member not in self.cls.__members__:
            return Unplaced(self.name, value)
        return self.cls[member]


class ReferenceObject:
    """Inert stand-in for a reference class other than its enums (history
    metrics, timers): takes any arguments, items and state; never read."""

    ref_name = "spr_pick"

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __setitem__(self, key, value):
        pass

    def append(self, value):
        pass

    def extend(self, values):
        pass

    def __repr__(self):
        return f"<{self.ref_name}>"


_PLACEHOLDERS: Dict[str, type] = {}


def _placeholder(module: str, name: str) -> type:
    key = f"{module}.{name}"
    if key not in _PLACEHOLDERS:
        _PLACEHOLDERS[key] = type(name, (ReferenceObject,), {"ref_name": key})
    return _PLACEHOLDERS[key]


_BUILTINS = frozenset(("list", "dict", "tuple", "set", "frozenset", "int",
                       "float", "complex", "str", "bytes", "bytearray",
                       "bool", "slice", "range"))
_TORCH_GLOBALS = {
    "torch._utils": lambda n: n.startswith("_rebuild_"),
    "torch._tensor": lambda n: n == "_rebuild_from_type_v2",
    "torch.nn.parameter": lambda n: n == "Parameter",
    "torch": lambda n: n in ("Size", "Tensor", "device")
    or isinstance(getattr(torch, n, None), torch.dtype),
}


class Unpickler(pickle.Unpickler):
    """Resolves every global itself; see the module docstring."""

    def find_class(self, module: str, name: str):
        if module == REF_PARAMS and name in REFERENCE_VALUES:
            return _EnumByValue(name)
        if module == "spr_pick" or module.startswith("spr_pick."):
            return _placeholder(module, name)
        allowed = _TORCH_GLOBALS.get(module)
        if (
            (allowed is not None and allowed(name))
            or (module == "collections"
                and name in ("OrderedDict", "defaultdict"))
            or (module == "builtins" and name in _BUILTINS)
            or (module == "_codecs" and name == "encode")
            or is_numpy_global(module)
        ):
            return super().find_class(module, name)
        raise CheckpointError(
            f"reference checkpoint references {module}.{name}, which the "
            "PyTorch port does not load (only spr_pick.* classes, torch "
            "tensors and numpy arrays are mapped)"
        )


def load(file, **kwargs):
    """``pickle.load`` through `Unpickler` (torch's legacy loader reads its
    header records with it)."""
    return Unpickler(file, **kwargs).load()


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

_REF_CLASSES: Dict[str, type] = {
    name: type(name, (), {"ref_enum": name}) for name in REFERENCE_VALUES
}


def reference_value(member: enum.Enum) -> Tuple[str, Any]:
    """(reference enum name, stored value) of one of this package's enum
    members; KeyError when the reference has no such member."""
    name = type(member).__name__
    if type(member) is not getattr(params, name, None):
        raise KeyError(f"{member!r} is not an enum of spr_pick_tpu_torch")
    return name, _WRITE_VALUES[name][member.name]


class Pickler(pickle._Pickler):
    """Pure-Python pickler (torch's savers subclass it and add
    ``persistent_id``) that writes this package's enum members as the
    reference's: ``spr_pick.params.<Enum>`` called with the reference
    value."""

    def reducer_override(self, obj):
        if isinstance(obj, enum.Enum) and type(obj).__module__ == params.__name__:
            name, value = reference_value(obj)
            return _REF_CLASSES[name], (value,)
        return NotImplemented

    def save_global(self, obj, name=None):
        ref = getattr(obj, "ref_enum", None)
        if ref is None or _REF_CLASSES.get(ref) is not obj:
            return super().save_global(obj, name)
        self.save(REF_PARAMS)
        self.save(ref)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dump(obj, file, protocol=None, **kwargs):
    Pickler(file, protocol, **kwargs).dump(obj)

