"""Convert a reference (PyTorch) spr_pick checkpoint to a file of this port.

    python -m spr_pick_tpu_torch.tools.import_reference_checkpoint \
        model_00080000.training -o converted.training --mode joint

The port of the root `tools/import_reference_checkpoint.py`, on `compat.py`:
no reference package is needed.  A `.training` becomes a `.training`
without optimizer state (the reference does not restore its own either), a
`.wt` a `.wt`; the JAX package reads both.  The conversion is optional:
every loader of the port reads reference files directly.
"""

from __future__ import annotations

import argparse

from spr_pick_tpu_torch.compat import load_reference_checkpoint
from spr_pick_tpu_torch.utils import checkpoint as ckpt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="reference .training or .wt file")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--mode", default="joint", choices=["joint", "denoise"])
    args = ap.parse_args(argv)

    state = load_reference_checkpoint(args.checkpoint, mode=args.mode)
    if "training" in state["format"]:
        ckpt.save_training(
            args.output, state["trainable"], state["static"], None,
            state["cfg"], state["mode"], state["iteration"],
        )
        print(f"converted .training (iteration {state['iteration']}) "
              f"-> {args.output}")
    else:
        ckpt.save_weights(args.output, state["trainable"], state["static"],
                          state["cfg"], state["mode"])
        print(f"converted .wt weights -> {args.output}")


if __name__ == "__main__":
    main()
