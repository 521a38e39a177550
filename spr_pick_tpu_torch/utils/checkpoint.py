"""Checkpoint load/save in the `.training` / `.wt` logical formats.

The files are pickled dicts of numpy trees in the flax layout
(`spr_pick_tpu/utils/checkpoint.py:32-69`): ``format``, ``cfg`` (keyed by
``ConfigValue`` members), ``mode``, ``trainable``, ``static`` and, for
``.training``, ``opt_state``, ``iteration``, ``rng_key`` and ``extra``.

Loading goes through an unpickler that resolves every global itself:

  * ``spr_pick_tpu.params.<Enum>`` -> this package's copy of that enum (the
    cfg of a file written by the JAX package is keyed by those members);
  * ``optax`` optimizer-state classes (a ``.training`` file's
    ``opt_state``, ``ScaleByAdamState(count, mu, nu)``) -> :class:`OptState`,
    a tuple that keeps the class name;
  * numpy's array and dtype reconstructors.

Anything else (another ``spr_pick_tpu``, ``jax`` or ``flax`` global) is
refused with a clear error.  A reference PyTorch checkpoint (torch's zip
archive or legacy stream) goes to `compat.py`, which reads it with its own
restricted unpickler (`utils/ref_pickle.py`).

`save_weights` and `save_training` write the same dict layout, and write
the globals under the JAX package's names: each enum class as
``spr_pick_tpu.params.<Enum>`` and the optimizer state as optax's
``ScaleByAdamState``, so the JAX package reads the port's files.  A
pure-Python pickler writes those names as opcodes; neither module is
imported.  Converting the numpy trees to and from module state is
`spr_pick_tpu_torch/weights.py`.
"""

from __future__ import annotations

import enum
import glob
import os
import pickle
import re
from typing import Any, Dict, Optional

from spr_pick_tpu_torch import params

WT_FORMAT = "spr_pick_tpu.wt.v1"
TRAINING_FORMAT = "spr_pick_tpu.training.v1"
_ADAM_MODULE = "optax._src.transform"

_ZIP_MAGIC = b"PK"  # torch>=1.6 serialisation (a reference checkpoint)


class CheckpointError(ValueError):
    """A checkpoint names something this loader refuses to construct."""


class OptState(tuple):
    """Stand-in for an optax state namedtuple (e.g. ``ScaleByAdamState``):
    the fields in order, and the optax class name in ``optax_name``.  It
    pickles like a namedtuple (``cls(*fields)``), under optax's name."""

    __slots__ = ()
    optax_name = "OptState"
    optax_module = _ADAM_MODULE

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"{self.optax_name}{tuple.__repr__(self)}"


_OPT_STATE_CLASSES: Dict[str, type] = {}


def _opt_state_class(name: str, module: str = _ADAM_MODULE) -> type:
    if name not in _OPT_STATE_CLASSES:
        _OPT_STATE_CLASSES[name] = type(name, (OptState,), {
            "__slots__": (), "optax_name": name, "optax_module": module})
    return _OPT_STATE_CLASSES[name]


ScaleByAdamState = _opt_state_class("ScaleByAdamState")


_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")


def is_numpy_global(module: str) -> bool:
    """Whether an unpickler may resolve globals of ``module``: numpy's
    array, dtype and scalar reconstructors and its RNG states."""
    return module in _NUMPY_MODULES or module.startswith("numpy.random")
_PARAMS_MODULES = ("spr_pick_tpu.params", "spr_pick_tpu_torch.params")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module in _PARAMS_MODULES:
            enum = getattr(params, name, None)
            if isinstance(enum, type):
                return enum
        elif module.startswith("optax.") and name.endswith("State"):
            return _opt_state_class(name, module)
        elif is_numpy_global(module):
            return super().find_class(module, name)
        raise CheckpointError(
            f"checkpoint references {module}.{name}, which the PyTorch port "
            "does not load (only spr_pick_tpu.params enums, optax optimizer "
            "states and numpy arrays are mapped)"
        )


def load(path: str, mode: str = "joint") -> Dict[str, Any]:
    """Load a `.wt` or `.training` file as a dict of numpy trees.

    The cfg comes back keyed by this package's enums.  A reference PyTorch
    checkpoint (a torch zip archive, or torch's legacy stream, whose first
    record is its magic number) is read and converted by
    `compat.load_reference_checkpoint` in the mode ``mode``
    (spr_pick_tpu/utils/checkpoint.py:72-116); the port's own files record
    their mode.
    """
    from spr_pick_tpu_torch import compat

    with open(path, "rb") as f:
        if f.read(2) == _ZIP_MAGIC:
            return compat.load_reference_checkpoint(path, mode=mode)
        f.seek(0)
        try:
            state = _Unpickler(f).load()
        except CheckpointError:
            raise
        except Exception as exc:
            try:
                return compat.load_reference_checkpoint(path, mode=mode)
            except Exception as ref_exc:
                raise CheckpointError(
                    f"could not load checkpoint {path!r}: not a .wt/.training "
                    f"pickle ({type(exc).__name__}: {exc}), and loading it "
                    "as a reference PyTorch checkpoint failed too (see the "
                    "chained error)") from ref_exc
    if compat.is_legacy_torch_magic(state):
        return compat.load_reference_checkpoint(path, mode=mode)
    if not isinstance(state, dict) or "trainable" not in state:
        raise CheckpointError(
            f"{path!r} is not a .wt/.training checkpoint (no 'trainable' tree)"
        )
    return state


class _JaxNamesPickler(pickle._Pickler):
    """Protocol-4 pickler that writes the port's enum classes and optimizer
    states under the JAX package's global names, as STACK_GLOBAL opcodes
    (the C pickler would import the module to check the name)."""

    def save_global(self, obj, name=None):
        if isinstance(obj, type) and issubclass(obj, OptState):
            target = (obj.optax_module, obj.optax_name)
        elif (isinstance(obj, type) and issubclass(obj, enum.Enum)
              and obj.__module__ == params.__name__):
            target = ("spr_pick_tpu.params", obj.__qualname__)
        else:
            return super().save_global(obj, name)
        self.save(target[0])
        self.save(target[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _dump(path: str, state: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        _JaxNamesPickler(f, protocol=4).dump(state)


def save_weights(path: str, trainable, static, cfg: Dict, mode: str) -> None:
    """Write a `.wt` (weights + cfg) in the JAX package's dict layout.

    ``trainable``/``static`` are numpy trees in the flax layout
    (`weights.state_to_flax`); ``cfg`` is keyed by this package's enums.
    """
    _dump(path, {
        "format": WT_FORMAT,
        "cfg": cfg,
        "mode": mode,
        "trainable": trainable,
        "static": static,
    })


def save_training(path: str, trainable, static, opt_state, cfg: Dict,
                  mode: str, iteration: int, rng_key=None,
                  extra: Optional[Dict] = None) -> None:
    """Write a resumable `.training` (spr_pick_tpu/utils/checkpoint.py:32-56):
    the weights, ``opt_state`` (a `ScaleByAdamState` of numpy trees in the
    flax layout), the iteration, the uint32[2] ``rng_key`` and ``extra``."""
    _dump(path, {
        "format": TRAINING_FORMAT,
        "cfg": cfg,
        "mode": mode,
        "iteration": int(iteration),
        "trainable": trainable,
        "static": static,
        "opt_state": opt_state,
        "rng_key": rng_key,
        "extra": extra or {},
    })


def find_latest_training(run_dir: str, subdir: str = "training_jt") -> str:
    """The max-iteration *.training file of a run dir
    (spr_pick_tpu/utils/checkpoint.py:119-129; reference train.py:1220-1230)."""
    iterations = {}
    for path in glob.glob(os.path.join(run_dir, subdir, "*.training")):
        found = re.findall(r"\d+", os.path.basename(path))
        if found:
            iterations[int(found[0])] = path
    if not iterations:
        raise ValueError("Run directory contains no training files.")
    return iterations[max(iterations)]
