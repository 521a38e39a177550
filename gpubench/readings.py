"""The readings the limits of ``correct`` are set from; the benchmark's
own runs never run this.

    python3 gpubench/readings.py --workload pick1k.joint_r8 \\
        --seeds 11,12,...  --control-seeds 21,22,23 [--out FILE]

For each of ``--seeds`` it does what a run does around its window (the
seed's weights, checkpoint, pool and `Picker`, the warm-up) and then
judges as many requests as a run checks, at the cell's own sizes: the
program's readings.  For each of ``--control-seeds`` it puts the control
in the program's place (the plain reference computed one precision step
below the configuration's: float8 for bf16) and judges its answers the
same way.
Prints one JSON line a seed and side, then the largest program reading
and the smallest control reading of each number.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json
    import shutil
    import tempfile

    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from gpubench.bench import use_checkout_caches
    from gpubench.harness import find_cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = find_cell(args.workload, ROOT)
    entry = cell.entry
    use_checkout_caches(ROOT)
    lines = []

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)

    sides = [("program", int(s)) for s in args.seeds.split(",") if s]
    sides += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for side, seed in sides:
        tmp = tempfile.mkdtemp(prefix="gpubench-readings-")
        try:
            prep = entry.prepare(cell, seed, "cuda", tmp)
            if side == "program":
                for i in range(int(cell.traffic["warmup"])):
                    entry.call(prep.program, prep.items[i % len(prep.items)])

                def answer_of(i):
                    return entry.call(prep.program, prep.items[i])
            else:
                def answer_of(i):
                    return entry.control(cell, prep, i, "cuda")
            idx = np.random.default_rng([seed, 3]).choice(
                len(prep.items),
                size=min(int(cell.traffic["checked"]), len(prep.items)),
                replace=False)
            worst = {}
            for i in idx:
                answer = answer_of(int(i))
                for k, v in entry.judge(cell, prep, int(i), answer,
                                        "cuda").items():
                    worst[k] = max(worst.get(k, -float("inf")), v)
            emit({"side": side, "seed": seed, **worst})
            prep.release()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
    recs = [json.loads(x) for x in lines]
    keys = sorted({k for r in recs for k in r if k not in ("side", "seed")})
    summary = {"workload": args.workload}
    for k in keys:
        prog = [r[k] for r in recs if r["side"] == "program" and k in r]
        ctl = [r[k] for r in recs if r["side"] == "control" and k in r]
        summary[k] = {"lower": max(prog) if prog else None,
                      "upper": min(ctl) if ctl else None,
                      "program_seeds": len(prog), "control_seeds": len(ctl)}
    emit({"summary": summary})
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
