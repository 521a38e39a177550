"""The system under test, `spr_pick_tpu_torch`, reached through its public
entry points: the configuration as the port's cfg, the seeded weights
written as a `.wt` checkpoint with the port's writer, and a `Picker` on
that checkpoint.  Nothing here computes a result the judge compares.

`prepare_picker` is the set-up of the entries that send micrographs to a
`Picker` one at a time (``pick``, ``denoise``)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from gpubench import data
from gpubench.reference import model as ref


def port_cfg(config: Dict) -> Dict:
    """The port's cfg: its defaults, then the configuration's values."""
    from spr_pick_tpu_torch import cfg as cfg_mod
    from spr_pick_tpu_torch.params import (ConfigValue, NoiseAlgorithm,
                                           NoiseValue)

    enums = {"ALGORITHM": NoiseAlgorithm, "NOISE_VALUE": NoiseValue}
    c = cfg_mod.base()
    for key, value in config["cfg"].items():
        c[ConfigValue[key]] = enums[key](value) if key in enums else value
    return c


def write_checkpoint(config: Dict, weights: Dict[str, torch.Tensor],
                     path: str, device) -> None:
    """The weights as the port's `.wt` of the configuration's mode.  The
    port's model must hold exactly the parameters the reference names."""
    from spr_pick_tpu_torch.denoiser import ESTIMATED_SIGMA, Denoiser
    from spr_pick_tpu_torch.utils import checkpoint as ckpt

    c = port_cfg(config)
    den = Denoiser(c, mode=config["mode"], device=device)
    model = {k: v for k, v in weights.items() if k != ESTIMATED_SIGMA}
    den.model.load_state_dict(model, strict=True)
    with torch.no_grad():
        den.l_params[ESTIMATED_SIGMA].copy_(weights[ESTIMATED_SIGMA])
    ckpt.save_weights(path, *den.variables(), c, config["mode"])


def open_picker(config: Dict, path: str, seed: int, device):
    from spr_pick_tpu_torch.api import Picker

    pick = config.get("pick", {})
    return Picker(path, mode=config["mode"], seed=int(seed), device=device,
                  threshold=pick.get("threshold", 0.02),
                  border=pick.get("border", 30))


@dataclass
class Prepared:
    """What a run of a `Picker` entry sets up: the seed, its weights (which
    the reference judges with), the pool as arrays (``raws``) and as MRC
    files (``items``, what a request sends), and the program (a
    `Picker`)."""
    seed: int
    weights: Dict[str, torch.Tensor]
    raws: List[np.ndarray]
    items: List[str]
    program: object

    def release(self) -> None:
        self.program = None


def sample_noise(shape, seed: int, device) -> torch.Tensor:
    """The (H, W) reparameterisation noise a `Picker` of ``seed`` draws:
    one standard-normal (1, H, W, 1) draw from a fresh generator on its
    device seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((1,) + tuple(shape) + (1,), generator=g,
                       device=device)[0, :, :, 0]


def prepare_picker(cell, seed: int, device, tmp: str) -> Prepared:
    """The seed's weights (with the detector's statistics set from the
    seed's own network on the pool's first micrograph, where the model
    asks for it), written as the program's checkpoint; the mix's pool,
    written as MRC files under ``tmp``; and the program's `Picker`."""
    ref.precisions(cell.config)          # refuse a precision with no judge
    model = cell.config["model"]
    weights = ref.make_weights(model, seed, device)
    raws = data.pool(seed, cell.traffic)
    if "picks_per_mpx" in model:
        img = ref.decoded(raws[0], device)
        ref.calibrate(weights, model, img,
                      sample_noise(img.shape, seed, device),
                      cell.config["cfg"]["NMS"],
                      cell.config["pick"]["threshold"])
        if torch.device(device).type == "cuda":
            # The peak the run reports is the program's, not set-up's.
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    wt = os.path.join(tmp, "model.wt")
    write_checkpoint(cell.config, weights, wt, device)
    paths = data.write_pool(raws, tmp)
    return Prepared(int(seed), weights, raws, paths,
                    open_picker(cell.config, wt, seed, device))
