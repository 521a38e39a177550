"""Train and eval steps: the optimizer, the train state, one update, the
K-step training chunks and the dense eval step.

Port of `spr_pick_tpu/steps.py`: `make_optimizer` (:31-35), the train
state (:24-28, `init_state` :38-47), one forward/backward/Adam/BatchNorm
update (`_grad_update`, `train_step`, :50-111), the host-facing metrics
(`_collect_metrics`, :83-98), the fused K-step programs `make_train_scan`
(:114-158), `make_train_scan_sharded` (:214-246), `make_denoise_scan`
(:249-294) and `make_denoise_scan_sharded` (:297-335), and the dense eval
step (:338-351).  The steps go through `Denoiser.run_pipeline`, so they
serve the joint mode and the four denoise-only pipelines alike.

The JAX package compiles K steps (the gather from the device stack, the
flip augment or the noise and UPS masking, the forwards, losses, Adam and
BatchNorm) into one `lax.scan`, so the host ships only (K, B) index and
label arrays and the K learning rates.  The port's chunk functions take the
same arrays, ship them to the device in one copy (`pack_rows`) and run the
same K steps: on a CUDA device each step is one replay of a CUDA graph of
the step (`utils/cuda_graph.py`: one graph launch instead of thousands of
kernel launches a step), under an NCCL mesh with the step's collectives
captured in it; on the CPU (gloo ranks included) the same step runs
eagerly, K times.  Everything a step reads or writes lives on the device
(Adam's count, bias corrections and learning rate included, and the
gradients, zeroed in place so their addresses stay put), which is what
lets a graph replay it.  Two differences from the JAX scan: the flips are
an input that the host draws from the data plane's `RandomState` (JAX
draws them in the program with `jax.random`), and the noise comes from
the trainer's and the data plane's generators, not from a key split.

The train state's trainable and static variables are the denoiser's
parameters and BatchNorm buffers; BatchNorm updates them in place in
train mode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spr_pick_tpu_torch.data.noisy import prepare_batch_torch
from spr_pick_tpu_torch.denoiser import Denoiser
from spr_pick_tpu_torch.parallel.mesh import owned_crops
from spr_pick_tpu_torch.params import PipelineOutput

ADAM_B1 = 0.9
ADAM_B2 = 0.99  # the reference's optim.Adam(betas=[0.9, 0.99])
ADAM_EPS = 1e-8


class ScaleByAdam:
    """``optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8)`` with the learning
    rate applied outside, as the JAX train step does:
    ``param += -lr * mu_hat / (sqrt(nu_hat) + eps)``.

    The moments are updated in optax's operation order
    (``(1 - b) * g**2 + b * nu``), and the step count and bias corrections
    are float32 on the device, as optax computes them, so the same
    gradients give optax's update to a few float32 ulps.  The state is
    optax's ``ScaleByAdamState``: one ``count`` for every parameter (the
    host int ``count``, written to checkpoints, beside the device float
    ``count_t`` that the update reads), and ``mu``/``nu`` aligned with
    ``params``.  A parameter without a gradient counts as a zero gradient.
    """

    def __init__(self, params: List[torch.Tensor]):
        self.params = list(params)
        self.count = 0
        self.count_t = torch.zeros((), dtype=torch.float32,
                                   device=self.params[0].device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def set_count(self, count: int) -> None:
        """Set the step count, on the host and on the device."""
        self.count = int(count)
        self.count_t.fill_(float(count))

    @torch.no_grad()
    def zero_grad(self) -> None:
        """Zero every gradient in place (a missing one is made once), so
        the gradients keep their addresses from one step to the next."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in self.params])

    @torch.no_grad()
    def update(self, lr: torch.Tensor) -> None:
        """One update on the device alone, the learning rate a 0-d float32
        tensor; the host ``count`` is the caller's to advance."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - ADAM_B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - ADAM_B2)
        torch._foreach_mul_(self.nu, ADAM_B2)
        torch._foreach_add_(self.nu, sq)
        self.count_t.add_(1)
        bc1 = 1 - torch.pow(ADAM_B1, self.count_t)
        bc2 = 1 - torch.pow(ADAM_B2, self.count_t)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        update = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(update, den)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)

    def step(self, lr) -> None:
        """`update` at ``lr`` (a float or a 0-d tensor), counted."""
        self.update(_lr_tensor(lr, self.count_t.device))
        self.count += 1


def _lr_tensor(lr, device) -> torch.Tensor:
    if isinstance(lr, torch.Tensor):
        return lr
    return torch.full((), lr, dtype=torch.float32, device=device)


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


def _collect_metrics(outputs: Dict, mesh=None,
                     mean: bool = False) -> Dict[str, torch.Tensor]:
    """Host-facing metric dict from pipeline outputs, still on the device:
    per-item losses (their means with ``mean``, as the scan paths stack
    them over K steps), scalar terms, mean noise/model s.d.  Under a mesh,
    the global batch's: per-item rows gathered in rank order, scalars
    averaged over the ranks."""
    def reduce(x):
        return torch.mean(x) if mean else x

    metrics = {"loss": reduce(outputs[PipelineOutput.LOSS].detach())}
    for key in (PipelineOutput.DENOISE_LOSS, PipelineOutput.DETECT_LOSS,
                PipelineOutput.AUG_LOSS):
        if key in outputs:
            metrics[key.value] = reduce(outputs[key].detach())
    for key in (PipelineOutput.NOISE_STD_DEV, PipelineOutput.MODEL_STD_DEV):
        if key in outputs:
            metrics[key.value] = torch.mean(outputs[key].detach())
    if mesh is not None:
        with torch.no_grad():
            metrics = {k: mesh.gather_rows(v) if v.ndim else
                       mesh.global_mean(v) for k, v in metrics.items()}
    return metrics


def _grad_update(state: TrainState, batch: Dict[str, torch.Tensor],
                 lr: torch.Tensor, alpha: float, tau: float,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """One forward/backward/Adam/BatchNorm update on the device alone (no
    host value read or written, so a CUDA graph can capture it); shared by
    `train_step` and the chunk functions, which keep the host counts.
    Returns the pipeline outputs."""
    den = state.denoiser
    state.opt.zero_grad()
    loss, outputs = den.run_pipeline(batch, True, alpha, tau,
                                     generator=generator, **(draws or {}))
    loss.backward()
    if den.mesh is not None:
        den.mesh.average_gradients(state.opt.params)
    state.opt.update(lr)
    return outputs


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], lr,
               alpha: float, tau: float,
               generator: Optional[torch.Generator] = None,
               ) -> Dict[str, torch.Tensor]:
    """One forward/backward/Adam/BatchNorm update, in place on ``state``
    (`_grad_update`, steps.py:50-80), at ``lr`` (a float or a 0-d device
    tensor), the pipeline's draws from ``generator``.  A parameter the
    loss does not reach (the detector of a denoise-only ssdn) gets a zero
    gradient.  Returns the step's metrics on the device.

    In a data-parallel run (``denoiser.mesh``), ``batch`` is this rank's
    slice of the global batch and the gradients are averaged over the
    ranks before Adam, so every rank applies the global-batch update."""
    den = state.denoiser
    outputs = _grad_update(state, batch, _lr_tensor(lr, den.device), alpha,
                           tau, generator)
    state.step += 1
    state.opt.count += 1
    return _collect_metrics(outputs, den.mesh)


# ---------------------------------------------------------------------------
# K-step training chunks
# ---------------------------------------------------------------------------

def pack_rows(*arrays) -> np.ndarray:
    """A chunk's per-step inputs as one (K, R) int32 array, row k holding
    step k's: each (K, ...) array flattened, float arrays as float32 bit
    patterns, so one copy ships them all and one device-to-device copy
    selects a step's row."""
    k = np.shape(arrays[0])[0]
    cols = []
    for a in arrays:
        a = np.asarray(a)
        if a.shape[:1] != (k,):
            raise ValueError(f"a chunk input of shape {a.shape}: {k} steps")
        a = (a.astype(np.float32).view(np.int32) if a.dtype.kind == "f"
             else a.astype(np.int32))
        cols.append(a.reshape(k, -1))
    return np.ascontiguousarray(np.concatenate(cols, axis=1))


def _fields(row: torch.Tensor, *layout):
    """Views of a packed row: ``layout`` is (width, is_float) per input, in
    `pack_rows` order; a float input of width 0 is one 0-d scalar."""
    out, at = [], 0
    for width, is_float in layout:
        view = row[at:at + max(width, 1)]
        at += max(width, 1)
        if is_float:
            view = view.view(torch.float32)
        out.append(view.reshape(()) if width == 0 else view)
    return out


class _Chunk:
    """K training steps from packed rows: one replay a step of a CUDA graph
    of the step on a CUDA device (`utils/cuda_graph.py`; under an NCCL mesh
    every rank captures the same step), the step itself K times on the CPU.

    ``step(state, images, row, generators, draws)`` runs one update from a
    packed row and returns its metrics (means over the batch).  The graph
    is captured for the first ``(state, images, generators)`` it is called
    with and replays on those only; `replays` and `eager_steps` count how
    the steps ran."""

    def __init__(self, step, mesh=None):
        self.step = step
        self.mesh = mesh
        self.names: Optional[List[str]] = None
        self.graph = None
        self._bound = None

    @property
    def replays(self) -> int:
        return 0 if self.graph is None else self.graph.replays

    @property
    def eager_steps(self) -> int:
        return 0 if self.graph is None else self.graph.eager_steps

    def _vector(self, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.names is None:
            self.names = list(metrics)
        return torch.stack([metrics[k].float() for k in self.names])

    def __call__(self, state: TrainState, images: torch.Tensor,
                 rows: np.ndarray, generators: Sequence,
                 draws: Optional[Sequence[Dict]] = None
                 ) -> Dict[str, torch.Tensor]:
        k = rows.shape[0]
        host = torch.from_numpy(rows)
        if images.device.type == "cuda":
            dev_rows = host.pin_memory().to(images.device, non_blocking=True)
        else:
            dev_rows = host.to(images.device)
        if images.device.type == "cuda":
            if draws is not None:
                raise ValueError("explicit draws: the eager chunk (CPU) only")
            out = self._graphed(state, images, generators).run(dev_rows)
        else:
            out = torch.stack([self._vector(self.step(
                state, images, dev_rows[i], generators,
                None if draws is None else draws[i])) for i in range(k)])
        state.step += k
        state.opt.count += k
        return dict(zip(self.names, out.unbind(1)))

    def _graphed(self, state, images, generators):
        from spr_pick_tpu_torch.utils.cuda_graph import GraphedSteps

        bound = (state, images, *generators)
        if self.graph is None:
            self._bound = bound
            self.graph = GraphedSteps(
                lambda row: self._vector(self.step(state, images, row,
                                                   generators, None)),
                generators=[g for g in generators if g is not None],
                params=state.opt.params, mesh=self.mesh)
        elif any(a is not b for a, b in zip(bound, self._bound)):
            raise ValueError("a graphed chunk replays on the state, stack "
                             "and generators it was captured with")
        return self.graph


def _gather(images, offset, f, y, x, flips, crop, centered, mesh):
    """The batch's crops from the device stack (this rank's shard under a
    mesh, summed over the ranks: every rank gets every crop)."""
    out = owned_crops(images, offset, f, y, x, flips, crop, centered)
    return out if mesh is None else mesh.global_sum(out)


def _joint_chunk(alpha: float, tau: float, crop: int, mesh):
    def step(state, images, row, generators, draws):
        b = (row.shape[0] - 1) // 5
        f, y, x, flips, labels, lr = _fields(
            row, (b, False), (b, False), (b, False), (b, False), (b, True),
            (0, True))
        offset = 0 if mesh is None else mesh.rank * images.shape[0]
        crops = _gather(images, offset, f, y, x, flips, crop, True, mesh)
        batch = {"inp": crops[..., None], "target": labels}
        if mesh is not None:
            batch = mesh.local(batch)
        outputs = _grad_update(state, batch, lr, alpha, tau, generators[0],
                               draws)
        return _collect_metrics(outputs, mesh, mean=True)

    chunk = _Chunk(step, mesh)

    def scan_steps(state: TrainState, images: torch.Tensor, flat, ys, xs,
                   flips, labels, lrs, generator: torch.Generator,
                   draws: Optional[Sequence[Dict]] = None
                   ) -> Dict[str, torch.Tensor]:
        """K joint steps.  ``images``: the (N, H, W) device stack (this
        rank's rows of it under a mesh); ``flat``/``ys``/``xs``: (K, B)
        image indices and crop centres, ``flips`` (K, B) 0/1 W-flips,
        ``labels`` (K, B) centre labels, ``lrs`` (K,): host arrays, shipped
        in one copy.  The pipeline draws from ``generator``, or takes step
        k's explicit draws ``draws[k]`` (``flip_p``, ``eps``, ``eps2``; the
        CPU only).  Updates ``state`` in place and returns each metric's
        (K,) stack of batch means (``_collect_metrics(mean=True)``)."""
        rows = pack_rows(flat, ys, xs, flips, labels, lrs)
        return chunk(state, images, rows, (generator,), draws)

    scan_steps.chunk = chunk
    return scan_steps


def make_train_scan(denoiser: Denoiser, alpha: float, tau: float, crop: int):
    """K joint train steps from the device micrograph stack (JAX
    `make_train_scan`): for each k the ``crop``-px crops centred at the
    draws, W-flipped where ``flips`` is set, through the joint pipeline,
    backward and Adam.  Returns ``scan_steps(state, images, flat, ys, xs,
    flips, labels, lrs, generator)``; on a CUDA device its steps are
    replays of one CUDA graph."""
    del denoiser  # the state carries it
    return _joint_chunk(alpha, tau, crop, mesh=None)


def make_train_scan_sharded(denoiser: Denoiser, alpha: float, tau: float,
                            crop: int, mesh):
    """`make_train_scan` with the stack sharded over the ranks of ``mesh``
    (JAX `make_train_scan_sharded`): each rank cuts the crops of the images
    it holds, the ranks sum them (`parallel/mesh.py:owned_crops`), each
    keeps its rows of the batch, and the gradients are averaged before
    Adam.  ``images`` is this rank's shard (`shard_stack`).  On cards
    (NCCL) its steps are replays of one CUDA graph of the step, the
    collectives captured in it; on gloo ranks they run eagerly."""
    del denoiser
    return _joint_chunk(alpha, tau, crop, mesh)


def _denoise_chunk(alpha: float, tau: float, patch: int, algorithm,
                   noise_style, noise_input: bool, mesh):
    def step(state, images, row, generators, draws):
        b = (row.shape[0] - 1) // 3
        f, y, x, lr = _fields(row, (b, False), (b, False), (b, False),
                              (0, True))
        offset = 0 if mesh is None else mesh.rank * images.shape[0]
        crops = _gather(images, offset, f, y, x, None, patch, False, mesh)
        batch = prepare_batch_torch(crops, algorithm, noise_style,
                                    generators[1], training=True,
                                    noise_input=noise_input)
        if mesh is not None:
            batch = mesh.local(batch)
        outputs = _grad_update(state, batch, lr, alpha, tau, generators[0],
                               draws)
        return _collect_metrics(outputs, mesh, mean=True)

    chunk = _Chunk(step, mesh)

    def scan_steps(state: TrainState, images: torch.Tensor, flat, ys, xs,
                   lrs, generator: torch.Generator,
                   data_generator: torch.Generator,
                   draws: Optional[Sequence[Dict]] = None
                   ) -> Dict[str, torch.Tensor]:
        """K denoise-only steps.  ``images``: the (N, H, W) device stack
        (this rank's rows under a mesh); ``flat``/``ys``/``xs``: (K, B)
        image indices and crop corners, ``lrs`` (K,): host arrays, shipped
        in one copy.  The input noise, UPS masking and reference noise
        (`data/noisy.py:prepare_batch_torch`) draw from ``data_generator``,
        the pipeline from ``generator`` or step k's ``draws[k]`` (the CPU
        only).  Updates ``state`` in place and returns each metric's (K,)
        stack of batch means."""
        rows = pack_rows(flat, ys, xs, lrs)
        return chunk(state, images, rows, (generator, data_generator), draws)

    scan_steps.chunk = chunk
    return scan_steps


def make_denoise_scan(denoiser: Denoiser, alpha: float, tau: float,
                      patch: int, algorithm, noise_style,
                      noise_input: bool = False):
    """K denoise-only train steps from the device image stack (JAX
    `make_denoise_scan`): for each k the ``patch``-px crops at the corners,
    the algorithm's input and reference, forward, backward and Adam.
    Returns ``scan_steps(state, images, flat, ys, xs, lrs, generator,
    data_generator)``; on a CUDA device its steps are replays of one CUDA
    graph."""
    del denoiser
    return _denoise_chunk(alpha, tau, patch, algorithm, noise_style,
                          noise_input, mesh=None)


def make_denoise_scan_sharded(denoiser: Denoiser, alpha: float, tau: float,
                              patch: int, algorithm, noise_style, mesh,
                              noise_input: bool = False):
    """`make_denoise_scan` with the stack sharded over the ranks of
    ``mesh`` (JAX `make_denoise_scan_sharded`; see
    `make_train_scan_sharded`): replays of one CUDA graph on cards, eager
    on gloo ranks."""
    del denoiser
    return _denoise_chunk(alpha, tau, patch, algorithm, noise_style,
                          noise_input, mesh)


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
