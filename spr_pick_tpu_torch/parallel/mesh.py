"""Data parallelism over cards: which ranks, their process group, and the
collectives the train step needs.

The port's counterpart of `spr_pick_tpu/parallel/mesh.py`.  The JAX
package builds a 1-D mesh over the local chips and lets GSPMD partition
the step; here each card is one process (rank) of a `torch.distributed`
group: NCCL on cards, gloo on the CPU (``device="cpu"``, what the tests
run).  The step keeps the mesh step's semantics, one step at global batch
B over D ranks equals the single-device step at batch B:

  * every rank draws the GLOBAL batch and the step's noise from the same
    seed and keeps its rows ``[r B/D, (r+1) B/D)`` (`Mesh.local`,
    `Mesh.local_rows`);
  * the batch-coupled terms (BatchNorm's batch statistics, the PU losses'
    sums) are summed over the ranks with `Mesh.global_sum`, an all-reduce
    whose backward all-reduces too;
  * the gradients are averaged over the ranks before Adam
    (`Mesh.average_gradients`).

Each rank's backward through `global_sum` yields D times its share of the
global gradient, as its local-mean terms do, so the average is the global
gradient.  A failing init, a missing card for a rank or a failing
collective raises: a run never falls back to one device.

The step's collectives can be captured in a CUDA graph on NCCL
(`utils/cuda_graph.py`): what they reduce (the gradient average's flat
buffer included) is allocated inside the capture, from the graph's own
memory pool, so a replay finds it where the capture put it, and none
reads a value on the host.  Every rank issues the same sequence of them
at every step, which is what lets each rank replay its graph against the
others'.  `any`, `broadcast_` and `broadcast_object` read or write the
host and run between replays.  The mesh holds the graphs that captured
its collectives (`hold_graph`) until `teardown` releases them.

The training micrograph stack is sharded, not replicated (JAX
`parallel/mesh.py:shard_stack`, `steps.py:_sharded_patch_gather`): rank r
holds rows ``[r n_l, (r+1) n_l)`` of the stack zero-padded to ``D n_l``
rows, ``n_l = ceil(N / D)`` (`shard_stack`), and a batch is each rank's
`owned_crops` (exact zeros for the images it does not hold) summed over
the ranks, so every rank ends with the crops of a replicated stack.

`resolve_size` resolves ``--mesh``/``MESH_SHAPE`` as the JAX trainer does
(train.py:201-221); `launch` starts D worker processes for one command,
and `join_torchrun` joins the group ``torchrun`` set up.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("mesh")

TIMEOUT = timedelta(minutes=10)


class MeshError(RuntimeError):
    """A mesh that cannot be built as asked."""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D ranks of the default process group; this process is ``rank``, on
    ``device``."""

    size: int
    rank: int
    device: torch.device
    _graphs: List = dataclasses.field(default_factory=list, init=False,
                                      repr=False, compare=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def local_rows(self, t: torch.Tensor, parts: int = 1) -> torch.Tensor:
        """This rank's rows of a global draw of ``parts`` stacked batches
        (the folded flip-TTA noise is [primary B; flipped B])."""
        n = t.shape[0] // parts
        if n % self.size or n * parts != t.shape[0]:
            raise MeshError(f"{t.shape[0]} rows ({parts} part(s)) do not "
                            f"split evenly over {self.size} ranks")
        b = n // self.size
        chunks = [t[p * n + self.rank * b: p * n + (self.rank + 1) * b]
                  for p in range(parts)]
        return chunks[0] if parts == 1 else torch.cat(chunks)

    def local(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's slice of a global batch (every value batched on its
        first dimension)."""
        return {k: self.local_rows(v) for k, v in batch.items()}

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks; differentiable (the backward all-reduces the
        incoming gradient)."""
        return _AllReduceSum.apply(t)

    def global_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks of per-rank means of equal-size shards: the
        global mean."""
        return self.global_sum(t) / self.size

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' row blocks concatenated in rank order (no gradient)."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    @torch.no_grad()
    def average_gradients(self, params: Sequence[torch.Tensor]) -> None:
        """All-reduce the gradients of ``params`` into their mean over the
        ranks, in one flat buffer; a missing gradient counts as zero."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat)
        flat /= self.size
        offset = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[offset: offset + n].view_as(p.grad))
            offset += n

    def hold_graph(self, graph) -> None:
        """Keep ``graph``, a CUDA graph that captured this group's
        collectives, until `teardown` releases it."""
        self._graphs.append(graph)

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` with rank 0's."""
        for t in tensors:
            dist.broadcast(t, 0)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, 0)
        return box[0]

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank."""
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the incoming gradient.  The
    backward runs on the autograd engine's device thread, on the stream of
    the forward's all-reduce, so under a CUDA graph's capture it is
    captured with the rest of the step."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def shard_rows(n: int, size: int, rank: int) -> Tuple[int, int]:
    """(first row, rows) of rank ``rank``'s shard of an N-row stack over
    ``size`` ranks: rows ``[r n_l, (r+1) n_l)`` of the stack zero-padded to
    ``D n_l``, as ``P(axis)`` places a JAX array padded by `shard_stack`."""
    n_local = -(-n // size)
    return rank * n_local, n_local


def shard_stack(host_stack, mesh: Mesh) -> Tuple[torch.Tensor, int]:
    """This rank's rows of an (N, ...) host stack on ``mesh.device``, and
    their first row (JAX `parallel/mesh.py:56-86`).

    Rows past N are zeros: N is padded up to a multiple of the mesh size
    with all-zero images, which no sampler index points at.  Only this
    rank's rows are read from ``host_stack`` (a numpy array, or any object
    with ``shape`` whose slices are numpy arrays) and copied to the
    device, so the whole stack never sits on one card."""
    n = host_stack.shape[0]
    offset, n_local = shard_rows(n, mesh.size, mesh.rank)
    rows = torch.from_numpy(np.ascontiguousarray(
        host_stack[offset:min(offset + n_local, n)]))
    local = torch.empty((n_local,) + tuple(host_stack.shape[1:]),
                        dtype=rows.dtype, device=mesh.device)
    local[:len(rows)].copy_(rows)
    local[len(rows):].zero_()
    return local, offset


def owned_crops(local: torch.Tensor, offset: int, flat, ys, xs, flips,
                crop: int, centered: bool) -> torch.Tensor:
    """(B, crop, crop) crops of the B global draws ``flat``, ``ys``,
    ``xs``, ``flips`` (numpy arrays, or integer tensors on the shard's
    device, which a CUDA graph can capture: no host copy), cut from the
    shard ``local`` whose first row is ``offset`` where it holds image
    ``flat[b]``, exact zeros elsewhere: one rank's part of JAX
    `steps.py:161-211`.  Summed over the ranks (`Mesh.global_sum`) they are
    the crops of the whole stack.

    ``centered=True`` (the joint plane): (ys, xs) are crop centres and a
    set flip bit mirrors the crop along W.  ``centered=False`` (the denoise
    plane): corners, and ``flips`` is None.  The draws must lie in their
    image; the row index is clamped into the shard before the mask, so a
    row this rank does not hold reads a row it does."""
    draws = [flat, ys, xs] + ([] if flips is None else [flips])
    if isinstance(flat, torch.Tensor):
        idx = torch.stack(draws).to(torch.int64)
    else:
        idx = torch.from_numpy(np.stack(draws).astype(np.int64)).to(
            local.device)
    half = crop // 2 if centered else 0
    rel = idx[0] - offset
    own = (rel >= 0) & (rel < local.shape[0])
    j = torch.arange(crop, device=local.device)
    rows = (idx[1] - half)[:, None] + j
    cols = (idx[2] - half)[:, None] + (
        j if flips is None else torch.where(idx[3][:, None] > 0,
                                            crop - 1 - j, j))
    out = local[rel.clamp(0, local.shape[0] - 1)[:, None, None],
                rows[:, :, None], cols[:, None, :]]
    return out.masked_fill_(~own[:, None, None], 0)


def _is_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def resolve_size(requested: Optional[int], device, batch: int) -> int:
    """The number of ranks for ``--mesh``/``MESH_SHAPE`` (train.py:201-221):
    None means every visible card when there are several (one rank on the
    CPU unless a size is asked for); a size larger than the visible cards
    raises, naming both counts; a global batch that the size does not
    divide runs on one device, with a warning."""
    if _is_cpu(device):
        size = requested or 1
    else:
        cards = torch.cuda.device_count()
        size = requested if requested is not None else max(cards, 1)
        if size > 1 and size > cards:
            raise MeshError(
                f"--mesh {size}: {size} GPUs are needed, {cards} visible")
    if size > 1 and batch % size:
        logger.warning("batch size %d not divisible by mesh size %d; "
                       "running single-device", batch, size)
        return 1
    return max(size, 1)


def init(rank: int, size: int, device, init_method: str,
         local_rank: Optional[int] = None) -> Mesh:
    """Join a group of ``size`` ranks as ``rank``: NCCL on cards (rank on
    ``cuda:local_rank``), gloo when ``device`` is the CPU."""
    if _is_cpu(device):
        dev = torch.device("cpu")
        backend = "gloo"
    else:
        local = rank if local_rank is None else local_rank
        if local >= torch.cuda.device_count():
            raise MeshError(f"rank {rank}: no card cuda:{local} "
                            f"({torch.cuda.device_count()} visible)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank, timeout=TIMEOUT,
                            **kwargs)
    return Mesh(size=size, rank=rank, device=dev)


def teardown(mesh: Mesh) -> None:
    """Leave the process group, releasing first the CUDA graphs that
    captured ``mesh``'s collectives (`Mesh.hold_graph`): NCCL may wait
    for a live graph that holds its collectives before it destroys the
    communicator."""
    if mesh._graphs:
        torch.cuda.synchronize(mesh.device)
        for graph in mesh._graphs:
            graph.reset()
        mesh._graphs.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def torchrun_size() -> int:
    """The world size ``torchrun`` set in the environment (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def join_torchrun(device=None) -> Mesh:
    """Join the group ``torchrun`` describes (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR/PORT in the environment)."""
    return init(int(os.environ["RANK"]), torchrun_size(), device, "env://",
                local_rank=int(os.environ.get("LOCAL_RANK", "0")))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, fn: Callable, size: int, device, init_method: str,
            args) -> None:
    mesh = init(rank, size, device, init_method)
    try:
        fn(mesh, *args)
    finally:
        teardown(mesh)


def launch(fn: Callable, size: int, device, *args) -> None:
    """Run ``fn(mesh, *args)`` in ``size`` new processes, one a rank, on
    127.0.0.1; raises when any of them fails (the others are stopped)."""
    import torch.multiprocessing as mp

    init_method = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(_worker, args=(fn, size, device, init_method, args),
                       nprocs=size, join=True, start_method="spawn")
