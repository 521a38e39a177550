"""Generate training manifest TSVs (`*_images.txt` / `*_coords.txt`).

    python -m spr_pick_tpu_torch.tools.generate_train_files micrographs/ \
        coords.star -o data/train
    # -> data/train_images.txt  (image_name<TAB>path)
    # -> data/train_coords.txt  (image_name<TAB>x_coord<TAB>y_coord)

The port of the root `generate_train_files.py`: scan a micrograph directory
and a coordinate file (or a directory of per-image files) and write the
manifests `train start` reads, with the same bytes, through `data/table.py`.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from spr_pick_tpu_torch.data import files as file_utils
from spr_pick_tpu_torch.data import table as tbl

IMAGE_EXTS = (".mrc", ".tiff", ".tif", ".png")
COORD_COLUMNS = ("image_name", "x_coord", "y_coord")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_dir",
                   help="Directory of micrographs (.mrc/.tiff/.png)")
    p.add_argument("coords", help="Coordinate file (.star/.box/.csv/.txt) or "
                   "directory of per-image files")
    p.add_argument("-o", "--output-prefix", default="train",
                   help="Output prefix; writes {prefix}_images.txt and "
                   "{prefix}_coords.txt")
    p.add_argument("--scale", type=float, default=1.0,
                   help="Divide coordinates by this factor (e.g. 4 for "
                   "8x->2x binning)")
    args = p.parse_args(argv)

    names, paths = [], []
    for path in sorted(glob.glob(os.path.join(args.image_dir, "*"))):
        name, ext = os.path.splitext(os.path.basename(path))
        if ext.lower() in IMAGE_EXTS:
            names.append(name)
            paths.append(os.path.abspath(path))
    if not names:
        raise SystemExit(f"no micrographs found in {args.image_dir}")
    images = {"image_name": np.array(names, dtype=object),
              "path": np.array(paths, dtype=object)}

    if os.path.isdir(args.coords):
        tables = [
            file_utils.read_coordinates(p)
            for p in sorted(glob.glob(os.path.join(args.coords, "*")))
            if os.path.splitext(p)[1] in file_utils.PARTICLE_FORMAT_MAP
        ]
    else:
        tables = [file_utils.read_coordinates(args.coords)]
    coords = tbl.concat([{k: t[k] for k in COORD_COLUMNS} for t in tables],
                        COORD_COLUMNS)

    if args.scale != 1.0:
        for k in ("x_coord", "y_coord"):
            coords[k] = (coords[k] / args.scale).astype(int)

    known = set(names)
    coord_names = [str(n) for n in coords["image_name"]]
    missing = sorted(set(coord_names) - known)
    if missing:
        print(f"warning: {len(missing)} coordinate image(s) have no "
              f"micrograph: {missing[:5]}{'...' if len(missing) > 5 else ''}")
    coords = tbl.select(coords, np.array([n in known for n in coord_names],
                                         dtype=bool))

    img_path = args.output_prefix + "_images.txt"
    coord_path = args.output_prefix + "_coords.txt"
    os.makedirs(os.path.dirname(os.path.abspath(img_path)), exist_ok=True)
    with open(img_path, "w") as f:
        tbl.write_tsv(f, images)
    with open(coord_path, "w") as f:
        tbl.write_tsv(f, coords)
    print(f"wrote {len(names)} micrographs -> {img_path}")
    print(f"wrote {tbl.num_rows(coords)} coordinates -> {coord_path}")


if __name__ == "__main__":
    main()
