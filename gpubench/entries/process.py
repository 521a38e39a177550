"""Entry ``process``: `Picker.process_table(path)`, one micrograph a
request (MRC read, the min-max quantise on the device, one dense forward
that gives both the detector's map and the posterior mean, K1, the
border filter, the table and the denoised image copied back), judged
against the plain reference of `reference/joint_var.py`: the pick table
as `entries/pick.py` judges it, the denoised image as
`entries/denoise.py` does.  The functions an entry gives are listed in
`gpubench/entries/pick.py`.

Set-up writes its own checkpoint: the configuration's model holds a
sigma net beside the joint model, which `program.write_checkpoint` does
not load.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from gpubench import data, program
from gpubench.entries import pick
from gpubench.reference import joint_var as jv
from gpubench.reference import model as ref
from gpubench.requests import mic_metrics

TINY = 1e-12   # a unit below this means the reference did not move
EXACT = pick.EXACT


def write_checkpoint(config: Dict, weights: Dict[str, torch.Tensor],
                     path: str, device) -> None:
    """The weights as the port's `.wt`: the joint model's and the sigma
    net's parameters, each module holding exactly those the reference
    names."""
    from spr_pick_tpu_torch.denoiser import Denoiser
    from spr_pick_tpu_torch.utils import checkpoint as ckpt

    c = program.port_cfg(config)
    den = Denoiser(c, mode=config["mode"], device=device)
    n = len(jv.SIGMA)
    den.model.load_state_dict(
        {k: v for k, v in weights.items() if not k.startswith(jv.SIGMA)},
        strict=True)
    den.sigma_model.load_state_dict(
        {k[n:]: v for k, v in weights.items() if k.startswith(jv.SIGMA)},
        strict=True)
    ckpt.save_weights(path, *den.variables(), c, config["mode"])


def prepare(cell, seed: int, device, tmp: str) -> program.Prepared:
    """`program.prepare_picker`'s set-up with the sigma net: the seed's
    weights, the detector's statistics and the sigma net's output bias
    set from the seed's own network on the pool's first micrograph, the
    checkpoint, the pool as MRC files under ``tmp``, and the `Picker`."""
    config, model = cell.config, cell.config["model"]
    ref.precisions(config)               # refuse a precision with no judge
    weights = jv.make_weights(model, seed, device)
    raws = data.pool(seed, cell.traffic)
    img = ref.decoded(raws[0], device)
    ref.calibrate(weights, model, img,
                  program.sample_noise(img.shape, seed, device),
                  config["cfg"]["NMS"], config["pick"]["threshold"])
    jv.calibrate_sigma(weights, model, img)
    if torch.device(device).type == "cuda":
        # The peak the run reports is the program's, not set-up's.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    wt = os.path.join(tmp, "model.wt")
    write_checkpoint(config, weights, wt, device)
    paths = data.write_pool(raws, tmp)
    return program.Prepared(int(seed), weights, raws, paths,
                            program.open_picker(config, wt, seed, device))


def call(picker, path: str):
    table, den = picker.process_table(path)
    out = {k: np.asarray(table[k]) for k in ("x_coord", "y_coord", "score")}
    out["denoised"] = den
    return out


def size(answer) -> int:
    """The table's picks, as in `entries/pick.py` (`k1_roofline.pick`
    reads them); ``mic_rate`` counts requests, one micrograph each."""
    return pick.size(answer)


def end_to_end(latencies, sizes, window_s: float, err) -> Dict[str, float]:
    return mic_metrics(latencies, sizes, window_s, err)


def reference_image(net: jv.Net, raw: np.ndarray, device) -> torch.Tensor:
    return net.denoised(ref.decoded(raw, device))


def control(cell, prep, index: int, device):
    """The control's answer: its pick table (`entries/pick.py`) and its
    denoised image, both from the reference in the precision below the
    configuration's."""
    out = pick.control(cell, prep, index, device)
    low = jv.Net(prep.weights, cell.config["model"],
                 ref.precisions(cell.config)[1])
    out["denoised"] = reference_image(low, prep.raws[index],
                                      device).cpu().numpy()
    return out


def judge(cell, prep, index: int, answer, device) -> Dict[str, float]:
    """`entries/pick.py`'s numbers of the pick table (``score_vs_bf16``,
    ``uncovered_px``, ``close_pairs``, ``border_out``, ``order_breaks``),
    and ``den_l2_vs_bf16`` and ``den_max_vs_bf16`` of the denoised image:
    the gap to the float32 reference's var posterior mean in units of
    what rounding the reference to the configuration's precision moves
    it, of the L2 norms and of the widest pixel gaps."""
    out = pick.judge(cell, prep, index, answer, device)
    model, raw = cell.config["model"], prep.raws[index]
    den = reference_image(jv.Net(prep.weights, model, "f32"), raw, device)
    den_unit = reference_image(
        jv.Net(prep.weights, model, ref.precisions(cell.config)[0]), raw,
        device)
    got = torch.as_tensor(np.asarray(answer["denoised"], np.float32),
                          device=den.device)
    if got.shape != den.shape:
        out.update(den_l2_vs_bf16=float("inf"), den_max_vs_bf16=float("inf"))
        return out
    diff, unit = got - den, den_unit - den
    out["den_l2_vs_bf16"] = float(diff.norm()) / max(float(unit.norm()), TINY)
    out["den_max_vs_bf16"] = (float(diff.abs().max())
                              / max(float(unit.abs().max()), TINY))
    return out
