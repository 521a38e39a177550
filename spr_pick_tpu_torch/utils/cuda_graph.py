"""One training step captured in a CUDA graph and replayed once a step.

The port's counterpart of the JAX package's fused K-step programs
(`spr_pick_tpu/steps.py:make_train_scan`, `make_denoise_scan` and their
sharded forms `make_train_scan_sharded`, `make_denoise_scan_sharded`),
which XLA compiles into one program, collectives included, so that the
host dispatches nothing a step.  An eager PyTorch step launches every
kernel from Python (2624 a joint step at the full width); a replay of a
captured step is one graph launch.

`GraphedSteps.run` takes a chunk's (K, R) rows of packed step inputs on the
device (`steps.pack_rows`) and runs the K steps:

  * the first `WARMUP_STEPS` steps of the first chunk run eagerly, on a
    side stream, as real steps of the run: they make the gradients and the
    library handles that capture must not create;
  * the next step is captured (capture executes nothing, so it is then
    replayed like every later one), reading its inputs from one static row
    buffer and writing its metrics to one static vector;
  * each step is then one device-to-device copy of row k into the static
    row, one graph replay, and one copy of the metrics out.

One graph of one step serves every chunk, whatever its K: a graph of K
steps would change at each boundary and hold K times the nodes.  The
generators that the step draws from (the trainer's, the denoise data
plane's) are registered with the graph, so each replay draws where the
eager step would have: a replay advances a generator's offset by what the
step consumes, and its state read between replays is the state an eager
run would have.  A capture or replay that fails raises; nothing falls back
to the eager loop.

Under an NCCL mesh (`parallel/mesh.py`) the step's collectives (the
sharded crops' sum, BatchNorm's global moments, the losses' sums, the
gradient average, the metrics) are captured with it: each rank warms up
and captures at the same step of the same chunk, its replays launch the
same collectives in the same order as every other rank's, and eager
collectives between replays (validation, the stop flag) run on the same
communicator after them, in stream order.  After the capture the ranks
agree that every rank captured (one eager all-reduce) before any of them
replays: a rank whose capture failed raises, and so does every other
rank, instead of replaying collectives that no peer will join.  The mesh
holds the graph (`Mesh.hold_graph`), and `parallel/mesh.py:teardown`
releases it before it leaves the process group.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

WARMUP_STEPS = 3  # eager steps before the capture (make_graphed_callables')


class GraphedSteps:
    """``step(row) -> metrics`` (a (M,) float32 tensor), captured once and
    replayed for each row.  ``params`` are the optimizer's parameters,
    whose gradients the graph writes in place: they must stay the tensors
    the graph was captured with.  ``mesh``: the ranks that capture the
    same step (None on one card).  `replays` and `eager_steps` count how
    the steps ran."""

    def __init__(self, step: Callable[[torch.Tensor], torch.Tensor],
                 generators: Sequence[torch.Generator],
                 params: Sequence[torch.Tensor], mesh=None):
        self.step = step
        self.generators = list(generators)
        self.params = list(params)
        self.mesh = mesh
        self.graph = None
        self.row = None
        self.out = None
        self.grads = None
        self.replays = 0
        self.eager_steps = 0
        self._stream = None

    def run(self, rows: torch.Tensor) -> torch.Tensor:
        """The K steps of ``rows`` (K, R) on the device; (K, M) metrics."""
        out = None
        for k in range(rows.shape[0]):
            if self.graph is None and self.eager_steps < WARMUP_STEPS:
                metrics = self._eager(rows[k])
            else:
                if self.graph is None:
                    self._capture(rows[k])
                self._check_grads()
                self.row.copy_(rows[k])
                self.graph.replay()
                self.replays += 1
                metrics = self.out
            if out is None:
                out = torch.empty((rows.shape[0],) + metrics.shape,
                                  dtype=metrics.dtype, device=metrics.device)
            out[k].copy_(metrics)
        return out

    def _eager(self, row: torch.Tensor) -> torch.Tensor:
        """One step on a side stream (capture's warm-up)."""
        current = torch.cuda.current_stream(row.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(row.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            metrics = self.step(row)
        current.wait_stream(self._stream)
        self.eager_steps += 1
        return metrics

    def _capture(self, row: torch.Tensor) -> None:
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot register a generator "
                "with a CUDA graph (CUDAGraph.register_generator_state): "
                "the training step draws from its own generators")
        for g in self.generators:
            graph.register_generator_state(g)
        self.row = torch.empty_like(row)
        error = None
        try:
            with torch.cuda.graph(graph):
                self.out = self.step(self.row)
        except Exception as exc:  # re-raised below, after the ranks agree
            error = exc
        if self.mesh is not None and self.mesh.any(error is not None) \
                and error is None:
            raise RuntimeError(
                f"rank {self.mesh.rank}: the training step's CUDA graph "
                "capture failed on another rank of the mesh")
        if error is not None:
            raise error
        if self.mesh is not None:
            self.mesh.hold_graph(graph)
        self.graph = graph
        self.grads = [p.grad for p in self.params]

    def _check_grads(self) -> None:
        if any(p.grad is not g for p, g in zip(self.params, self.grads)):
            raise RuntimeError("a parameter's gradient was replaced after "
                               "the capture; the graph writes the old one")
