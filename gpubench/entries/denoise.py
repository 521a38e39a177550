"""Entry ``denoise``: `Picker.denoise(path)`, one micrograph a request
(MRC decode, the dense U-Net fold, the ssdn posterior mean, the copy to
the host), judged against the plain reference's denoised image.  The
functions an entry gives are listed in `gpubench/entries/pick.py`."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpubench import program
from gpubench.reference import model as ref
from gpubench.requests import mic_metrics

TINY = 1e-12   # a unit below this means the reference did not move
EXACT = ()

prepare = program.prepare_picker


def call(picker, path: str):
    return picker.denoise(path)


def size(answer) -> int:
    return int(np.asarray(answer).size)


def end_to_end(latencies, sizes, window_s: float, err) -> Dict[str, float]:
    return mic_metrics(latencies, sizes, window_s, err)


def reference_image(net: "ref.Net", raw: np.ndarray, device):
    return ref.with_tf32_off(net.denoised, ref.decoded(raw, device))


def control(cell, prep, index: int, device):
    """The control's denoised image: the reference in the precision below
    the configuration's."""
    low = ref.Net(prep.weights, cell.config["model"],
                  ref.precisions(cell.config)[1])
    return reference_image(low, prep.raws[index], device).cpu().numpy()


def judge(cell, prep, index: int, answer, device) -> Dict[str, float]:
    """The gap to the float32 reference in units of what rounding the
    reference to the configuration's precision moves its output:
    ``den_l2_vs_bf16``, of the L2 norms; ``den_max_vs_bf16``, of the
    widest pixel gaps."""
    model, raw = cell.config["model"], prep.raws[index]
    den = reference_image(ref.Net(prep.weights, model, "f32"), raw, device)
    den_unit = reference_image(
        ref.Net(prep.weights, model, ref.precisions(cell.config)[0]), raw,
        device)
    got = torch.as_tensor(np.asarray(answer, np.float32), device=den.device)
    if got.shape != den.shape:
        return {"den_l2_vs_bf16": float("inf"),
                "den_max_vs_bf16": float("inf")}
    diff, unit = got - den, den_unit - den
    return {"den_l2_vs_bf16": float(diff.norm()) / max(float(unit.norm()),
                                                       TINY),
            "den_max_vs_bf16": float(diff.abs().max())
            / max(float(unit.abs().max()), TINY)}
