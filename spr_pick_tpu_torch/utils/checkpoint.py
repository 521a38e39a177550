"""Checkpoint load/save in the `.training` / `.wt` logical formats.

The files are pickled dicts of numpy trees in the flax layout
(`spr_pick_tpu/utils/checkpoint.py:32-69`): ``format``, ``cfg`` (keyed by
``ConfigValue`` members), ``mode``, ``trainable``, ``static`` and, for
``.training``, ``opt_state``, ``iteration``, ``rng_key`` and ``extra``.

Loading goes through an unpickler that resolves every global itself:

  * ``spr_pick_tpu.params.<Enum>`` -> this package's copy of that enum (the
    cfg of a file written by the JAX package is keyed by those members);
  * ``optax`` optimizer-state classes (a ``.training`` file's
    ``opt_state``) -> :class:`OptState`, a tuple that keeps the class name;
  * numpy's array and dtype reconstructors, and the port's own enums.

Anything else (another ``spr_pick_tpu``, ``jax`` or ``flax`` global, or a
reference PyTorch checkpoint, which needs ``compat.py``: a later slice) is
refused with a clear error.

`save_weights` writes the same dict layout keyed by the port's own enums;
the JAX package cannot read those files yet (ROADMAP.md).  Converting the
numpy trees to and from module state is `spr_pick_tpu_torch/weights.py`.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

from spr_pick_tpu_torch import params

WT_FORMAT = "spr_pick_tpu.wt.v1"

_ZIP_MAGIC = b"PK"  # torch>=1.6 serialisation (a reference checkpoint)


class CheckpointError(ValueError):
    """A checkpoint names something this loader refuses to construct."""


class OptState(tuple):
    """Stand-in for an optax state namedtuple (e.g. ``ScaleByAdamState``):
    the fields in order, and the optax class name in ``optax_name``."""

    optax_name = "OptState"

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __repr__(self):
        return f"{self.optax_name}{tuple.__repr__(self)}"


def _opt_state_class(name: str) -> type:
    return type(name, (OptState,), {"optax_name": name})


_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_PARAMS_MODULES = ("spr_pick_tpu.params", "spr_pick_tpu_torch.params")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module in _PARAMS_MODULES:
            enum = getattr(params, name, None)
            if isinstance(enum, type):
                return enum
        elif module.startswith("optax.") and name.endswith("State"):
            return _opt_state_class(name)
        elif module in _NUMPY_MODULES or module.startswith("numpy.random"):
            return super().find_class(module, name)
        raise CheckpointError(
            f"checkpoint references {module}.{name}, which the PyTorch port "
            "does not load (only spr_pick_tpu.params enums, optax optimizer "
            "states and numpy arrays are mapped)"
        )


def load(path: str) -> Dict[str, Any]:
    """Load a `.wt` or `.training` file as a dict of numpy trees.

    The cfg comes back keyed by this package's enums.
    """
    with open(path, "rb") as f:
        if f.read(2) == _ZIP_MAGIC:
            raise CheckpointError(
                f"{path!r} is a PyTorch zip checkpoint (a reference "
                "checkpoint); converting those is compat.py, which the port "
                "does not have yet — convert it with the JAX package first"
            )
        f.seek(0)
        state = _Unpickler(f).load()
    if not isinstance(state, dict) or "trainable" not in state:
        raise CheckpointError(
            f"{path!r} is not a .wt/.training checkpoint (no 'trainable' tree)"
        )
    return state


def save_weights(path: str, trainable, static, cfg: Dict, mode: str) -> None:
    """Write a `.wt` (weights + cfg) in the JAX package's dict layout.

    ``trainable``/``static`` are numpy trees in the flax layout
    (`weights.state_to_flax`); ``cfg`` is keyed by this package's enums.
    """
    state = {
        "format": WT_FORMAT,
        "cfg": cfg,
        "mode": mode,
        "trainable": trainable,
        "static": static,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=4)
