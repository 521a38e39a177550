"""Aggregate `*_scores.txt` picks into a RELION .star file.

    python -m spr_pick_tpu_torch.tools.convert_to_star RUN_DIR/eval_imgs \
        -o particles.star --threshold 0.13 --scale 4

The port of the root `convert_to_star.py`, on `data/star_export.convert`:
picks above the threshold, coordinates multiplied by the scale (undoing a
binning), and an optional keep-window applied after scaling (the reference
run used 15 1425 15 1009).
"""

from __future__ import annotations

import argparse

from spr_pick_tpu_torch.data.star_export import convert


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scores_dir", help="Directory containing *_scores.txt files")
    p.add_argument("-o", "--output", default="particles.star")
    p.add_argument("--threshold", type=float, default=0.13)
    p.add_argument("--scale", type=float, default=4.0,
                   help="Coordinate upscale factor (binning undo)")
    p.add_argument("--borders", type=int, nargs=4,
                   metavar=("XMIN", "XMAX", "YMIN", "YMAX"), default=None,
                   help="Keep picks with XMIN<x<XMAX and YMIN<y<YMAX "
                   "(applied after scaling); reference run used 15 1425 15 "
                   "1009")
    args = p.parse_args(argv)

    try:
        n = convert(args.scores_dir, args.output, args.threshold,
                    args.scale, args.borders)
    except FileNotFoundError as exc:
        raise SystemExit(str(exc))
    print(f"wrote {n} particles to {args.output}")


if __name__ == "__main__":
    main()
