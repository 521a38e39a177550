"""The pipeline engine: the joint mode and the denoise-only mode.

PyTorch port of `spr_pick_tpu/denoiser.py`: model building from the cfg
and the flip-TTA fold policy (`__post_init__`, :60-143), the dense-route
preconditions (:209-233), the dense forward with its fused route
(`_apply_model`, :235-284), the noise estimate, and the pipelines with their `run_pipeline`
dispatch (:540-553): `joint_pipeline` (:324-432), split here into the
dense evaluation branch (`joint_pipeline`) and the training branch on
crops (`joint_train_pipeline`); `ssdn_pipeline` (:434-491, one channel and
the 3-channel diagonal or full covariance); `mse_pipeline` (:493-513, n2c,
n2n, ssdn_u_only) and `mask_mse_pipeline` (:515-538, n2v).  Training always
runs on crops and evaluation always densely, as every caller of the JAX
package does.

The model is `JointNetwork` in joint mode and for ssdn (whose denoise-only
training still runs the detector for its BatchNorm statistics), and the
single-head `BlindspotUNet` for the mse pipelines.  The engine owns its
modules (the model, the `var` sigma net) and the learnable constant sigma
on ``device``: the GPU unless the caller passes another
(`utils/device.py`).  JAX's (trainable, static) variable split is the
modules' parameters and BatchNorm buffers (`trainable_parameters`,
`variables`), and flax's ``mutable=["batch_stats"]`` is train mode
(`train()`): BatchNorm then normalises with the batch's statistics and
updates its running statistics in place.  The compute dtype comes from
``cfg[COMPUTE_DTYPE]``: bf16 by default, float32 on request; parameters
and BatchNorm statistics stay float32, the heads return float32 and the
NLL/PME math runs in float32.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from spr_pick_tpu_torch import cfg as cfg_mod
from spr_pick_tpu_torch import losses, weights
from spr_pick_tpu_torch.models import BlindspotUNet, JointNetwork
from spr_pick_tpu_torch.models.resnet import ResNet8
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
    """Holds the cfg, the modules and the learnable sigma; runs the
    pipelines of ``mode`` ("joint" or "denoise") for evaluation and for
    training.

    ``fold_tta`` (joint mode): run the flip-TTA consistency forward folded into the
    primary one as a 2B batch (one BatchNorm update over the fold) instead
    of a second, sequential forward (two updates, the second starting from
    the first's running statistics).  None resolves as in the JAX package
    (denoiser.py:60-87): off at a train batch of exactly 16, on otherwise;
    ``SPR_FOLD_TTA=0/1`` overrides either way.  The batch it reads is the
    cfg's, the global batch of a data-parallel run.

    ``mesh`` (`parallel/mesh.py`): training runs on this rank's rows of
    the global batch.  BatchNorm statistics and the PU loss's sums are
    taken over the global batch, and the flip draw and the sample noise
    are drawn for the global batch from the same generator on every rank,
    each rank keeping its rows; explicit draws passed in are global too.
    """

    def __init__(self, cfg: Dict, mode: str = "joint",
                 device: torch.device | str | None = None,
                 fold_tta: Optional[bool] = None, mesh=None):
        env_fold = os.environ.get("SPR_FOLD_TTA")
        if env_fold in ("0", "1"):
            fold_tta = env_fold == "1"
        elif fold_tta is None:
            fold_tta = cfg.get(ConfigValue.TRAIN_MINIBATCH_SIZE) != 16
        self.fold_tta = fold_tta
        if mode not in ("joint", "denoise"):
            raise ValueError(f"mode {mode!r}: expected 'joint' or 'denoise'")
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

        if mode == "joint" or self.pipeline == Pipeline.SSDN:
            # The reference always builds JointNetwork (denoiser_v2.py:99-107).
            self.model = JointNetwork(
                in_channels=in_ch, out_channels=out_ch,
                blindspot=self.blindspot, dtype=dtype,
            )
        else:
            # Single-head U-Net for the mse / n2v pipelines.
            self.model = BlindspotUNet(
                in_channels=in_ch, out_channels=out_ch,
                blindspot=self.blindspot, dtype=dtype,
            )
        self.model = self.model.to(self.device).eval()
        self.sigma_model = None
        if (self.pipeline == Pipeline.SSDN
                and self.noise_value == NoiseValue.UNKNOWN_VARIABLE):
            # DualNetworkShallow sigma estimator (denoiser_v2.py:129-137).
            self.sigma_model = BlindspotUNet(
                in_channels=in_ch, out_channels=1, blindspot=False, levels=3,
                dtype=dtype,
            ).to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            # `models.resnet.batch_norm` reads it: global batch statistics.
            for m in self.model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.mesh = mesh
        self.l_params: Dict[str, torch.Tensor] = {}
        if (self.pipeline == Pipeline.SSDN
                and self.noise_value == NoiseValue.UNKNOWN_CONSTANT):
            # Learnable scalar sigma (denoiser_v2.py:158-164).
            self.l_params[ESTIMATED_SIGMA] = torch.zeros(
                (1, 1, 1, 1), device=self.device, requires_grad=True
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
        """Load the numpy (trainable, static) trees of a checkpoint, in
        place (an optimizer keeps its references)."""
        states = weights.flax_to_state(trainable, static)
        self.model.load_state_dict(states["model"])
        if self.sigma_model is not None:
            self.sigma_model.load_state_dict(states["sigma"])
        with torch.no_grad():
            for k, t in self.l_params.items():
                t.copy_(states["l_params"][k])

    def named_trainable(self) -> List[Tuple[str, str, torch.Tensor]]:
        """(group, state key, tensor) of every trainable tensor, in a fixed
        order: the JAX trainable tree's leaves (`weights.py` maps the
        names)."""
        out = [("model", k, p) for k, p in self.model.named_parameters()]
        if self.sigma_model is not None:
            out += [("sigma", k, p)
                    for k, p in self.sigma_model.named_parameters()]
        out += [("l_params", k, t) for k, t in self.l_params.items()]
        return out

    def trainable_parameters(self) -> List[torch.Tensor]:
        return [t for _, _, t in self.named_trainable()]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every parameter and buffer, in a fixed order (what a
        data-parallel run broadcasts from rank 0)."""
        out = [t for _, _, t in self.named_trainable()]
        out += list(self.model.buffers())
        if self.sigma_model is not None:
            out += list(self.sigma_model.buffers())
        return out

    def _draw(self, given: Optional[torch.Tensor], rows: int, shape,
              generator, device, parts: int = 1) -> torch.Tensor:
        """A standard-normal draw of ``parts`` stacked batches of ``rows``
        local rows each, ``given`` or from ``generator``; under a mesh it is
        drawn (or given) for the global batch and this rank keeps its
        rows."""
        d = 1 if self.mesh is None else self.mesh.size
        if given is None:
            given = torch.randn((parts * rows * d,) + tuple(shape),
                                generator=generator, device=device)
        return given if self.mesh is None else \
            self.mesh.local_rows(given, parts)

    def train(self, mode: bool = True) -> "Denoiser":
        """Train mode (batch statistics, running updates) or eval mode."""
        self.model.train(mode)
        if self.sigma_model is not None:
            self.sigma_model.train(mode)
        return self

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
    def has_joint_model(self) -> bool:
        return isinstance(self.model, JointNetwork)

    @property
    def supports_rect_dense(self) -> bool:
        """Whether dense eval handles RECTANGULAR micrographs natively (the
        two-lane fold), so the data layer can skip square padding.
        Non-blind-spot models always do; a blind-spot model only through
        the fused route of `JointNetwork` (denoiser.py:209-217): a
        single-head blind-spot U-Net (ssdn_u_only) runs its own rot4
        forward, which needs a square."""
        if not self.blindspot:
            return True
        return self.has_joint_model and self.in_channels == 1

    def _can_fuse_dense(self, inp: torch.Tensor) -> bool:
        """Fused dense preconditions (denoiser.py:219-233): blind-spot
        joint model, one input channel, H and W on the 32-px pad grid."""
        return (
            self.has_joint_model
            and self.blindspot
            and self.in_channels == 1
            and inp.ndim == 4
            and inp.shape[1] % 32 == 0
            and inp.shape[2] % 32 == 0
        )

    def _apply_model(self, inp, eps=None, generator=None,
                     detect: bool = True) -> Tuple:
        """(net_out, hm_logits) of the main model, dense, in eval mode.

        A joint model's U-Net takes the folded forward when
        `_can_fuse_dense` holds (rot4 or two-lane), its own otherwise; then
        the reparameterised sample and the dilated detector, unless
        ``detect`` is False (the denoise-only pipelines read no logits).
        hm_logits is None for a single-head model."""
        if not self.has_joint_model:
            return self.model(inp), None
        if self._can_fuse_dense(inp):
            out_stats = dense_blindspot_unet(self.model.denoise_branch, inp)
        else:
            out_stats = self.model.denoise_branch(inp)
        if not detect:
            return out_stats, None
        z = self.model.sample(out_stats, eps, generator)
        return out_stats, self.model.detector(z, dense=True)

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
    # Pipelines
    # ------------------------------------------------------------------

    def run_pipeline(self, batch: Dict[str, torch.Tensor], train: bool,
                     alpha: float = 0.0, tau: float = 0.0,
                     generator: Optional[torch.Generator] = None, **draws,
                     ) -> Tuple[torch.Tensor, Dict[PipelineOutput, torch.Tensor]]:
        """The pipeline of this mode and cfg (denoiser.py:540-553):
        training on crops (``train``) or dense evaluation.  ``draws`` are
        the pipeline's own explicit draws (``eps``; joint training also
        ``flip_p``, ``eps2``); those not given come from ``generator``.
        Returns (mean loss, outputs)."""
        if self.mode == "joint":
            if train:
                return self.joint_train_pipeline(batch, alpha, tau,
                                                 generator=generator, **draws)
            outputs = self.joint_pipeline(batch, generator=generator, **draws)
            return torch.mean(outputs[PipelineOutput.LOSS]), outputs
        if self.pipeline == Pipeline.SSDN:
            return self.ssdn_pipeline(batch, train, generator=generator,
                                      **draws)
        if self.pipeline == Pipeline.MSE:
            return self.mse_pipeline(batch)
        if self.pipeline == Pipeline.MASK_MSE:
            return self.mask_mse_pipeline(batch)
        raise NotImplementedError("Unsupported processing pipeline")

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
        zero = torch.zeros((), device=inp.device)
        outputs = self._nll_outputs(inp, net_out, batch)
        outputs.update({
            PipelineOutput.DENOISE_LOSS: outputs[PipelineOutput.LOSS],
            PipelineOutput.DETECT_LOSS: zero,
            PipelineOutput.AUG_LOSS: zero,
            PipelineOutput.DETECT: losses.clamped_sigmoid(hm_logits),
        })
        return outputs

    def joint_train_pipeline(
        self, batch: Dict[str, torch.Tensor], alpha: float, tau: float,
        eps: Optional[torch.Tensor] = None,
        flip_p: Optional[torch.Tensor] = None,
        eps2: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[PipelineOutput, torch.Tensor]]:
        """The training branch of `joint_pipeline` (denoiser.py:324-432;
        denoiser_v2.py:253-589): crops, strided detector, the modules in
        train mode.

        batch: inp (B,H,W,1) crops and target (B,) PU labels (-1
        unlabeled).  Flip-TTA: one uniform draw ``flip_p`` flips the
        batch along W (``flip_p <= 0.5``) or H; the flipped forward runs
        folded with the primary one (noise ``eps`` of 2B) or after it
        (``eps`` then ``eps2``, B each), and its logits are flipped back.
        Loss = alpha * nll + (1 - alpha) * pu_loss(slack 4) + 0.1 *
        mean((p - p_flipped)^2).  Draws not given come from ``generator``
        in the order flip_p, eps, eps2.  Returns (mean loss, outputs).
        """
        inp = batch["inp"]
        b = inp.shape[0]

        def normal(given, parts=1):
            return self._draw(given, b, inp.shape[1:], generator, inp.device,
                              parts)

        if flip_p is None:
            flip_p = torch.rand((), generator=generator, device=inp.device)
        w_flip = flip_p <= 0.5
        inp_f = torch.where(w_flip, inp.flip(2), inp.flip(1))
        if self.fold_tta:
            eps = normal(eps, parts=2)
            net_out2, hm_logits2 = self.model(torch.cat([inp, inp_f]), False,
                                              eps)
            net_out, hm_logits = net_out2[:b], hm_logits2[:b]
            hm_logits_f = hm_logits2[b:]
        else:
            eps = normal(eps)
            net_out, hm_logits = self.model(inp, False, eps)
            eps2 = normal(eps2)
            # BatchNorm updates again, from the first forward's statistics.
            _, hm_logits_f = self.model(inp_f, False, eps2)
        hm_logits_f = torch.where(w_flip, hm_logits_f.flip(2),
                                  hm_logits_f.flip(1))
        hm_p = losses.clamped_sigmoid(hm_logits)
        hm_p_f = losses.clamped_sigmoid(hm_logits_f)
        pred_loss = losses.pu_loss(hm_p, batch["target"], tau, slack=4.0,
                                   mesh=self.mesh)
        consis_loss = torch.mean((hm_p - hm_p_f) ** 2)
        if self.mesh is not None:
            consis_loss = self.mesh.global_mean(consis_loss)

        outputs = self._nll_outputs(inp, net_out, batch)
        loss_out = outputs[PipelineOutput.LOSS]
        final_loss = (alpha * loss_out + (1 - alpha) * pred_loss
                      + 0.1 * consis_loss)
        outputs.update({
            PipelineOutput.LOSS: final_loss,
            PipelineOutput.DENOISE_LOSS: loss_out,
            PipelineOutput.DETECT_LOSS: pred_loss,
            PipelineOutput.AUG_LOSS: consis_loss,
            PipelineOutput.DETECT: hm_p,
        })
        return torch.mean(final_loss), outputs

    def ssdn_pipeline(self, batch: Dict[str, torch.Tensor], train: bool,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      ) -> Tuple[torch.Tensor, Dict[PipelineOutput, torch.Tensor]]:
        """Denoise-only ssdn (denoiser.py:434-491; denoiser_v2.py:598-849):
        the NLL/PME of the U-Net's (mu | A), one channel or several.

        In training the detector still runs, in train mode, on the sample
        ``z = mu + eps * A**2`` (``eps`` given, or drawn from
        ``generator``): the JAX package applies the whole `JointNetwork`
        with ``mutable=["batch_stats"]``, so its BatchNorm running
        statistics move although no loss reads the logits.  The detector's
        parameters get no gradient.  Crops narrower than the detector's
        receptive field (63 px) skip it: flax returns an empty map there and
        NaN running statistics.  Evaluation runs the U-Net alone, dense (the
        JAX program drops the unused detector).
        """
        inp = batch["inp"]
        if train:
            net_out = self.model.denoise_branch(inp)
            if min(inp.shape[1:3]) >= ResNet8.width:
                if self.mesh is not None:
                    eps = self._draw(
                        eps, inp.shape[0],
                        tuple(inp.shape[1:3]) + (self.in_channels,),
                        generator, inp.device)
                with torch.no_grad():
                    self.model.detector(
                        self.model.sample(net_out, eps, generator))
        else:
            net_out, _ = self._apply_model(inp, detect=False)
        outputs = self._nll_outputs(inp, net_out, batch)
        return torch.mean(outputs[PipelineOutput.LOSS]), outputs

    def mse_pipeline(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[PipelineOutput, torch.Tensor]]:
        """n2c / n2n / ssdn_u_only plain MSE of the single-head U-Net
        (denoiser.py:493-513; denoiser_v2.py:209-226), on crops or dense:
        the loss only where the batch has a ``ref``."""
        cleaned = self.model(batch["inp"])
        outputs = {PipelineOutput.IMG_DENOISED: cleaned}
        loss = torch.zeros((), device=cleaned.device)
        if "ref" in batch:
            loss = losses.mse_per_item(cleaned, batch["ref"])
            outputs[PipelineOutput.LOSS] = loss
        return torch.mean(loss), outputs

    def mask_mse_pipeline(self, batch: Dict[str, torch.Tensor]
                          ) -> Tuple[torch.Tensor,
                                     Dict[PipelineOutput, torch.Tensor]]:
        """n2v masked MSE (denoiser.py:515-538; denoiser_v2.py:228-249),
        summed over the UPS mask per item, where the batch has ``ref`` and
        ``mask``."""
        cleaned = self.model(batch["inp"])
        outputs = {PipelineOutput.IMG_DENOISED: cleaned}
        loss = torch.zeros((), device=cleaned.device)
        if "ref" in batch and "mask" in batch:
            loss = losses.masked_mse(cleaned, batch["ref"], batch["mask"])
            outputs[PipelineOutput.LOSS] = loss
        return torch.mean(loss), outputs

    def _nll_outputs(self, inp, net_out, batch) -> Dict:
        """The ssdn NLL/PME (denoiser.py:452-490): one channel with
        sigma_x = A**2; several (denoise mode) with sigma_x = A^T A, A
        diagonal or upper triangular (row-major, as ``np.triu_indices``; the
        indices are made on the device, which a CUDA graph can capture),
        through `full_cov_nll_pme`."""
        c = self.in_channels
        if c != 1 and self.mode == "joint":
            raise NotImplementedError(
                "joint mode supports single-channel micrographs"
            )
        mu_x = net_out[..., 0:c]
        a_c = net_out[..., c:self.out_channels]
        known = self.noise_value == NoiseValue.KNOWN
        noise_std = self._noise_std(inp, mu_x, batch)
        if c == 1:
            loss_map, pme_out, net_std, noise_std_out = \
                losses.gaussian_nll_pme(inp, mu_x, a_c ** 2, noise_std,
                                        known_noise=known)
        else:
            if self.cfg[ConfigValue.DIAGONAL_COVARIANCE]:
                sigma_x = torch.diag_embed(a_c ** 2)
            else:
                tri = a_c.new_zeros(a_c.shape[:-1] + (c, c))
                rows, cols = torch.triu_indices(c, c, device=a_c.device)
                tri[..., rows, cols] = a_c
                sigma_x = torch.einsum("...ji,...jk->...ik", tri, tri)
            loss_map, pme_out, net_std, noise_std_out = \
                losses.full_cov_nll_pme(
                    inp, mu_x, sigma_x,
                    torch.broadcast_to(noise_std, inp.shape),
                    known_noise=known)
        loss_out = loss_map.reshape(loss_map.shape[0], -1).mean(1, keepdim=True)
        return {
            PipelineOutput.IMG_MU: mu_x,
            PipelineOutput.IMG_DENOISED: pme_out,
            PipelineOutput.LOSS: loss_out,
            PipelineOutput.NOISE_STD_DEV: noise_std_out,
            PipelineOutput.MODEL_STD_DEV: net_std,
        }
