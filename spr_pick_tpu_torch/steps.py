"""Train and eval steps: the optimizer, the train state and one update.

Port of `spr_pick_tpu/steps.py`: `make_optimizer` (:31-35), the train
state (:24-28, `init_state` :38-47), one forward/backward/Adam/BatchNorm
update (`_grad_update`, `train_step`, :50-111), the host-facing metrics
(`_collect_metrics`, :83-98) and the dense eval step (:338-351).  Both
steps go through `Denoiser.run_pipeline`, so they serve the joint mode and
the four denoise-only pipelines alike.

PyTorch runs eagerly, so there is nothing to compile: the trainer calls
`train_step` once a step in a Python loop.  The JAX package's K-step
`lax.scan` programs (:114-336) exist to save XLA dispatches; the port runs
the same per-step update and has no fused K-step program.  The train
state's trainable and static variables are the denoiser's parameters and
BatchNorm buffers; BatchNorm updates them in place in train mode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.params import PipelineOutput

ADAM_B1 = 0.9
ADAM_B2 = 0.99  # the reference's optim.Adam(betas=[0.9, 0.99])
ADAM_EPS = 1e-8


class ScaleByAdam:
    """``optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8)`` with the learning
    rate applied outside, as the JAX train step does:
    ``param += -lr * mu_hat / (sqrt(nu_hat) + eps)``.

    The moments are updated in optax's operation order
    (``(1 - b) * g**2 + b * nu``), and the bias corrections are float32, so
    the same gradients give optax's update to a few float32 ulps.  The
    state is optax's ``ScaleByAdamState``: one ``count`` for every
    parameter, and ``mu``/``nu`` aligned with ``params``.  A parameter
    without a gradient counts as a zero gradient.
    """

    def __init__(self, params: List[torch.Tensor]):
        self.params = list(params)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - ADAM_B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - ADAM_B2)
        torch._foreach_mul_(self.nu, ADAM_B2)
        torch._foreach_add_(self.nu, sq)
        self.count += 1
        count = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** count)
        bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** count)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        update = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(update, den)
        torch._foreach_mul_(update, -float(np.float32(lr)))
        torch._foreach_add_(self.params, update)


@dataclasses.dataclass
class TrainState:
    """Step count, the denoiser (its parameters are the trainable
    variables, its BatchNorm buffers the static ones) and the optimizer."""

    step: int
    denoiser: Denoiser
    opt: ScaleByAdam


def make_optimizer(denoiser: Denoiser) -> ScaleByAdam:
    return ScaleByAdam(denoiser.trainable_parameters())


def init_state(denoiser: Denoiser, seed: int = 0) -> TrainState:
    """Seeded fresh variables and a fresh optimizer (step 0)."""
    denoiser.init_variables(seed=seed)
    return TrainState(step=0, denoiser=denoiser, opt=make_optimizer(denoiser))


def _collect_metrics(outputs: Dict, mesh=None) -> Dict[str, torch.Tensor]:
    """Host-facing metric dict from pipeline outputs, still on the device:
    per-item losses, scalar terms, mean noise/model s.d.  Under a mesh, the
    global batch's: per-item rows gathered in rank order, scalars
    averaged over the ranks."""
    metrics = {"loss": outputs[PipelineOutput.LOSS].detach()}
    for key in (PipelineOutput.DENOISE_LOSS, PipelineOutput.DETECT_LOSS,
                PipelineOutput.AUG_LOSS):
        if key in outputs:
            metrics[key.value] = outputs[key].detach()
    for key in (PipelineOutput.NOISE_STD_DEV, PipelineOutput.MODEL_STD_DEV):
        if key in outputs:
            metrics[key.value] = torch.mean(outputs[key].detach())
    if mesh is not None:
        with torch.no_grad():
            metrics = {k: mesh.gather_rows(v) if v.ndim else
                       mesh.global_mean(v) for k, v in metrics.items()}
    return metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], lr: float,
               alpha: float, tau: float,
               generator: Optional[torch.Generator] = None,
               ) -> Dict[str, torch.Tensor]:
    """One forward/backward/Adam/BatchNorm update, in place on ``state``
    (`_grad_update`, steps.py:50-80), the pipeline's draws from
    ``generator``.  A parameter the loss does not reach (the detector of a
    denoise-only ssdn) gets no gradient, which Adam counts as zero.
    Returns the step's metrics on the device.

    In a data-parallel run (``denoiser.mesh``), ``batch`` is this rank's
    slice of the global batch and the gradients are averaged over the
    ranks before Adam, so every rank applies the global-batch update."""
    den = state.denoiser
    for p in state.opt.params:
        p.grad = None
    loss, outputs = den.run_pipeline(batch, True, alpha, tau,
                                     generator=generator)
    loss.backward()
    if den.mesh is not None:
        den.mesh.average_gradients(state.opt.params)
    state.opt.step(lr)
    state.step += 1
    return _collect_metrics(outputs, den.mesh)


def eval_step(denoiser: Denoiser, batch: Dict[str, torch.Tensor],
              eps: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              ) -> Dict[PipelineOutput, torch.Tensor]:
    """Run the dense eval pipeline (no grads, no BN update) on ``batch``;
    a joint model's sample noise is ``eps``, or is drawn from
    ``generator``, or from a generator seeded with 0."""
    draws = {} if eps is None else {"eps": eps}
    with torch.inference_mode():
        return denoiser.run_pipeline(batch, False, generator=generator,
                                     **draws)[1]
