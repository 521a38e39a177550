"""Run `chip_smoke.py` with phase 14's rate measurements repeated, to test
the profiled replays of its graphed training chunks for crashes.

    python scripts/phase14_repeat.py [--rounds N] [--fault FILE]

The whole script runs as ``python3 chip_smoke.py`` does (one CUDA card).
After phase 14, `chunk_rates` (graphed and eager rates, then host launches
and a traced window, each inside a torch.profiler session) runs
``--rounds`` more times on phase 10's joint trainer and on phase 14's ssdn
and n2v trainers.  Before phase 14 it logs which tensors of phase 10's
trainer (its state, its gradients, its stack on the card) lie at another
address than at the end of phase 10.  The Python stack of a crash goes to
``--fault`` (all threads), since the end of standard error is what a
remote run keeps.  Exit code: the script's.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--fault", default=os.path.join(REPO, "chiprun_out",
                                                    "fault.txt"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    os.makedirs(os.path.dirname(os.path.abspath(args.fault)), exist_ok=True)
    fault = open(args.fault, "w")

    class ToFile:  # chip_smoke.main enables the handler on stderr
        @staticmethod
        def enable():
            faulthandler.enable(fault, all_threads=True)

    cs.faulthandler = ToFile
    k1_in_training, graph_phase = cs.k1_in_training, cs.graph_phase
    first = {}

    def addresses(t):
        out = {n: x.data_ptr() for n, x in cs.state_tensors(t.train_state)}
        out["stack"] = t.patch_pipeline.images_dev.data_ptr()
        out.update((f"grad {i}", p.grad.data_ptr())
                   for i, p in enumerate(t.train_state.opt.params))
        return out

    def k1_in_training_(*a, **kw):
        t, launches = k1_in_training(*a, **kw)
        if not first:  # phase 10's one-card trainer
            first.update(addresses(t))
        return t, launches

    def graph_phase_(t10, runs11, paths10, tmp, gpu):
        now = addresses(t10)
        moved = [n for n in first if now.get(n) != first[n]]
        cs.log(f"phase 10's trainer: {len(moved)} of {len(first)} tensors "
               f"at another address than at the end of phase 10: {moved}")
        dn = graph_phase(t10, runs11, paths10, tmp, gpu)
        for r in range(args.rounds):
            cs.log(f"extra rates, round {r + 1} of {args.rounds}")
            cs.chunk_rates("train joint", t10, gpu)
            for algo in ("ssdn", "n2v"):
                cs.chunk_rates(f"dn train {algo}", dn[algo], gpu)
        return dn

    cs.k1_in_training, cs.graph_phase = k1_in_training_, graph_phase_
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
