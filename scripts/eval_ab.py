"""Time `chip_smoke.py` phase 9's eval (four 1024^2 micrographs, bf16, with
artifacts) for one or more checkouts of the repo, on one CUDA card.

    python scripts/eval_ab.py [--rounds N] [--flags 0|01] ROOT [ROOT ...]

Each ROOT (a checkout: `chip_smoke.py` and `spr_pick_tpu_torch/`) runs in
a child process of its own, in the order given, so a comparison of two
commits reads "parent change change parent".  A child makes the phase's
seeded weights and micrographs, runs the eval once per flag to warm up,
then ``--rounds`` times more with ``SPR_EVAL_PIPELINE`` set to each of
``--flags`` in turn (the order alternating a round), and prints one JSON
line a flag: the median, min, max and spread in ms and micrographs/s.  A
checkout whose evaluator has no such setting ignores it.  The card's name
and power limit come first and last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def child(root: str, flags: str, rounds: int) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    import torch
    from spr_pick_tpu_torch.data import mrc
    from spr_pick_tpu_torch.data.loader import load_image
    from spr_pick_tpu_torch.eval import DenoiserEvaluator
    from spr_pick_tpu_torch.params import ConfigValue

    with tempfile.TemporaryDirectory() as tmp:
        mic = os.path.join(tmp, "mic.mrc")
        mrc.write(mic, cs.micrograph(cs.SIZE, cs.SEED))
        paths = cs.make_checkpoints(tmp, load_image(mic))
        mics = {"a_1024": cs.SEED, "b_1024": cs.SEED + 10}
        manifest = os.path.join(tmp, "eval_1024.txt")
        with open(manifest, "w") as f:
            f.write("image_name\tpath\n")
            for name, seed in mics.items():
                path = os.path.join(tmp, name + ".mrc")
                mrc.write(path, cs.micrograph(cs.SIZE, seed))
                f.write(f"{name}\t{path}\n")
        ev = DenoiserEvaluator(paths["main"],
                               runs_dir=os.path.join(tmp, "runs"))
        ev.set_test_data(manifest)
        n = 4
        ev.cfg[ConfigValue.NUM_EVAL] = n
        for flag in flags:
            os.environ["SPR_EVAL_PIPELINE"] = flag
            ev.evaluate()
            torch.cuda.synchronize()
        times = {flag: [] for flag in flags}
        for r in range(rounds):
            for flag in (flags if r % 2 == 0 else flags[::-1]):
                os.environ["SPR_EVAL_PIPELINE"] = flag
                t0 = time.perf_counter()
                ev.evaluate()
                torch.cuda.synchronize()
                times[flag].append(1e3 * (time.perf_counter() - t0))
    for flag, ms in times.items():
        med = statistics.median(ms)
        print(json.dumps({
            "root": root, "SPR_EVAL_PIPELINE": flag, "median_ms": med,
            "min_ms": min(ms), "max_ms": max(ms),
            "spread_pct": 100 * (max(ms) - min(ms)) / med,
            "micrographs_per_s": 1e3 * n / med, "n": len(ms), "ms": ms,
        }), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--rounds", type=int, default=12)
    parser.add_argument("--flags", default="0")
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.roots[0], args.flags, args.rounds)
        return 0
    print(card(), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        "--rounds", str(args.rounds), "--flags", args.flags,
                        root], check=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
