"""The dense-inference eval step.

Port of `spr_pick_tpu/steps.py:make_eval_step` (:338-351): the joint
pipeline with ``train=False`` under ``torch.inference_mode()``.  PyTorch
runs eagerly, so there is nothing to compile; the train steps belong to
the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.params import PipelineOutput


def eval_step(denoiser: Denoiser, batch: Dict[str, torch.Tensor],
              eps: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              ) -> Dict[PipelineOutput, torch.Tensor]:
    """Run the dense eval pipeline (no grads, no BN update) on ``batch``;
    the sample noise is ``eps``, or is drawn from ``generator``, or from a
    generator seeded with 0."""
    with torch.inference_mode():
        return denoiser.joint_pipeline(batch, eps=eps, generator=generator)
