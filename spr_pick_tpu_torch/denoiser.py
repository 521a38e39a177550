"""The evaluation side of the pipeline engine.

PyTorch port of `spr_pick_tpu/denoiser.py` for dense inference: model
building from the cfg (`__post_init__`), the dense-route preconditions, the
fused dense forward (`_apply_model_fused`, :235-264), the noise estimate and
the `joint_pipeline` branch with ``train=False`` (:324-432).  Training, the
denoise-only pipelines and the stitch detector belong to later slices.

The engine owns its modules (`JointNetwork`, the `var` sigma net) and the
learnable constant sigma on ``device``: the GPU unless the caller passes
another (`utils/device.py`).  The compute dtype comes from
``cfg[COMPUTE_DTYPE]``: bf16 by default, float32 on request; the heads
return float32 and the NLL/PME math runs in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import losses, weights
from spr_pick_tpu_torch.models import BlindspotUNet, JointNetwork
from spr_pick_tpu_torch.ops.dense_unet import dense_blindspot_unet
from spr_pick_tpu_torch.params import (
    ConfigValue,
    NoiseValue,
    Pipeline,
    PipelineOutput,
)
from spr_pick_tpu_torch.utils.device import resolve_device

_DTYPES = {"bf16": torch.bfloat16, "f32": None, None: None}

ESTIMATED_SIGMA = "estimated_sigma"


def _num_output_components(channels: int, diagonal: bool) -> int:
    # Means + triangular A (denoiser_v2.py:70-77).
    if diagonal:
        return channels * 2
    return channels + (channels * (channels + 1)) // 2


class Denoiser:
    """Holds the cfg, the modules and the learnable sigma; runs the joint
    evaluation pipeline."""

    def __init__(self, cfg: Dict, mode: str = "joint",
                 device: torch.device | str | None = None):
        if mode != "joint":
            raise NotImplementedError(
                f"mode {mode!r}: the denoise-only pipelines are not ported "
                "yet (ROADMAP.md, queue 1, denoise-only algorithms)"
            )
        c = cfg
        cfg_mod.infer(c, model_only=True)
        self.cfg = c
        self.mode = mode
        self.device = resolve_device(device)
        in_ch = c[ConfigValue.IMAGE_CHANNELS]
        self.in_channels = in_ch
        self.pipeline = c[ConfigValue.PIPELINE]
        self.blindspot = c[ConfigValue.BLINDSPOT]
        self.noise_value: Optional[NoiseValue] = c.get(ConfigValue.NOISE_VALUE)
        self.noise_style: Optional[str] = c.get(ConfigValue.NOISE_STYLE)

        if self.pipeline == Pipeline.SSDN:
            out_ch = _num_output_components(
                in_ch, c[ConfigValue.DIAGONAL_COVARIANCE]
            )
        else:
            out_ch = in_ch
        self.out_channels = out_ch
        dtype = _DTYPES[c.get(ConfigValue.COMPUTE_DTYPE)]
        self.compute_dtype = dtype

        # Reference always builds JointNetwork in joint mode
        # (denoiser_v2.py:99-107).
        self.model = JointNetwork(
            in_channels=in_ch, out_channels=out_ch, blindspot=self.blindspot,
            dtype=dtype,
        ).to(self.device).eval()
        self.sigma_model = None
        if (self.pipeline == Pipeline.SSDN
                and self.noise_value == NoiseValue.UNKNOWN_VARIABLE):
            # DualNetworkShallow sigma estimator (denoiser_v2.py:129-137).
            self.sigma_model = BlindspotUNet(
                in_channels=in_ch, out_channels=1, blindspot=False, levels=3,
                dtype=dtype,
            ).to(self.device).eval()
        self.l_params: Dict[str, torch.Tensor] = {}
        if (self.pipeline == Pipeline.SSDN
                and self.noise_value == NoiseValue.UNKNOWN_CONSTANT):
            # Learnable scalar sigma (denoiser_v2.py:158-164).
            self.l_params[ESTIMATED_SIGMA] = torch.zeros(
                (1, 1, 1, 1), device=self.device
            )

    # ------------------------------------------------------------------
    # Variables
    # ------------------------------------------------------------------

    def init_variables(self, seed: int = 0) -> None:
        """Seeded random init of every module, in place (the flax
        initialisers' distributions, not their draws)."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.model.reset_parameters(g)
            if self.sigma_model is not None:
                self.sigma_model.reset_parameters(g)
            for t in self.l_params.values():
                t.zero_()

    def load_variables(self, trainable: Dict, static: Dict) -> None:
        """Load the numpy (trainable, static) trees of a checkpoint."""
        states = weights.flax_to_state(trainable, static)
        self.model.load_state_dict(states["model"])
        if self.sigma_model is not None:
            self.sigma_model.load_state_dict(states["sigma"])
        for k in self.l_params:
            self.l_params[k] = states["l_params"][k].to(self.device)

    def variables(self) -> Tuple[Dict, Dict]:
        """The inverse of `load_variables`: (trainable, static) numpy trees."""
        states = {"model": self.model.state_dict()}
        if self.sigma_model is not None:
            states["sigma"] = self.sigma_model.state_dict()
        if self.l_params:
            states["l_params"] = self.l_params
        return weights.state_to_flax(states)

    # ------------------------------------------------------------------
    # Forward helpers
    # ------------------------------------------------------------------

    @property
    def supports_rect_dense(self) -> bool:
        """Whether dense eval handles RECTANGULAR micrographs natively (the
        two-lane fold), so the data layer can skip square padding."""
        return not self.blindspot or self.in_channels == 1

    def _can_fuse_dense(self, inp: torch.Tensor) -> bool:
        """Fused dense preconditions: blind-spot model, one input channel,
        H and W on the 32-px pad grid."""
        return (
            self.blindspot
            and self.in_channels == 1
            and inp.ndim == 4
            and inp.shape[1] % 32 == 0
            and inp.shape[2] % 32 == 0
        )

    def _apply_model_fused(self, inp, eps, generator) -> Tuple:
        """Dense inference through the folded U-Net forward, then the
        reparameterised sample and the dilated detector."""
        out_stats = dense_blindspot_unet(self.model.denoise_branch, inp)
        z = self.model.sample(out_stats, eps, generator)
        return out_stats, self.model.detector(z, dense=True)

    def _apply_model(self, inp, eps, generator) -> Tuple:
        """(net_out, hm_logits) of the main model, dense, in eval mode."""
        if self._can_fuse_dense(inp):
            return self._apply_model_fused(inp, eps, generator)
        return self.model(inp, True, eps, generator)

    def _noise_estimate(self, noisy_in: torch.Tensor) -> Optional[torch.Tensor]:
        """Raw noise estimate before softplus remap (const or var)."""
        if self.noise_value == NoiseValue.UNKNOWN_CONSTANT:
            return self.l_params[ESTIMATED_SIGMA]
        if self.noise_value == NoiseValue.UNKNOWN_VARIABLE:
            est = self.sigma_model(noisy_in)
            # Per-image scalar: mean over H, W (denoiser_v2.py:390).
            return torch.mean(est, dim=(1, 2), keepdim=True)
        return None

    def _noise_std(self, noisy_in, mu_x, batch) -> torch.Tensor:
        """Distill the noise s.d. per style/params (denoiser_v2.py:379-424,
        with the `known` branch reading batch['noise_std'])."""
        style = self.noise_style or "gauss"
        if self.noise_value == NoiseValue.KNOWN:
            params_in = batch.get("noise_std")
            if params_in is None:
                raise ValueError(
                    "noise_value=known requires batch['noise_std'] (N111)"
                )
            if style.startswith("gauss"):
                return torch.clamp(params_in, min=1e-3)
            if style.startswith("poisson"):
                return (torch.clamp(mu_x, min=1e-3) / params_in) ** 0.5
        est = losses.softplus_noise_remap(self._noise_estimate(noisy_in))
        if style.startswith("poisson"):
            return (torch.clamp(mu_x, min=1e-3) * est) ** 0.5
        return est

    # ------------------------------------------------------------------
    # Pipeline
    # ------------------------------------------------------------------

    def joint_pipeline(self, batch: Dict[str, torch.Tensor],
                       eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       ) -> Dict[PipelineOutput, torch.Tensor]:
        """Joint denoise + detect, dense, in eval mode (`joint_pipeline`
        with ``train=False, dense=True``, denoiser_v2.py:253-589).

        batch: inp (B,H,W,C) on this engine's device.  The sample noise is
        ``eps`` when given, else drawn from ``generator`` (on the input's
        device), else from a generator seeded with 0.  Returns the
        pipeline outputs keyed by `PipelineOutput`.
        """
        inp = batch["inp"]
        if eps is None and generator is None:
            generator = torch.Generator(device=inp.device).manual_seed(0)
        net_out, hm_logits = self._apply_model(inp, eps, generator)
        hm_p = losses.clamped_sigmoid(hm_logits)

        c = self.in_channels
        if c != 1:
            raise NotImplementedError(
                "joint mode supports single-channel micrographs"
            )
        mu_x = net_out[..., 0:c]
        sigma_x = net_out[..., c:self.out_channels] ** 2
        noise_std = self._noise_std(inp, mu_x, batch)
        loss_map, pme_out, net_std, noise_std_out = losses.gaussian_nll_pme(
            inp, mu_x, sigma_x, noise_std,
            known_noise=self.noise_value == NoiseValue.KNOWN,
        )
        loss_out = loss_map.reshape(loss_map.shape[0], -1).mean(1, keepdim=True)
        zero = torch.zeros((), device=inp.device)
        return {
            PipelineOutput.IMG_MU: mu_x,
            PipelineOutput.IMG_DENOISED: pme_out,
            PipelineOutput.LOSS: loss_out,
            PipelineOutput.DETECT_LOSS: zero,
            PipelineOutput.DENOISE_LOSS: loss_out,
            PipelineOutput.AUG_LOSS: zero,
            PipelineOutput.NOISE_STD_DEV: noise_std_out,
            PipelineOutput.MODEL_STD_DEV: net_std,
            PipelineOutput.DETECT: hm_p,
        }
