"""Run one cell of the benchmark of `spr_pick_tpu_torch` on this machine.

    python3 gpubench/run.py --workload pick1k.joint_r8 --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``;
with ``--trace 1`` the per-layer metrics, the device's busy and window
seconds and a ``breakdown``; ``checks`` last: each number compared with
its limit).  The last lines of standard error repeat the checks.  Exits
nonzero, printing no result, without as many CUDA devices as the cell
asks for, or if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    from gpubench.harness import find_cell

    cell = find_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from gpubench.bench import run_cell

    run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
