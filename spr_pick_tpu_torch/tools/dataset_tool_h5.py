"""Build an HDF5 image dataset ('images' + 'shapes' + 'names') from a folder.

    python -m spr_pick_tpu_torch.tools.dataset_tool_h5 images_dir \
        -o dataset.h5

The port of the root `tools/dataset_tool_h5.py`, the format `data/hdf5.py`
reads: every image (as the folder dataset loads it) in a float32, gzip
compressed (n, max H, max W) array, its (H, W) in ``shapes`` and its name
in ``names``.  Needs h5py.
"""

from __future__ import annotations

import argparse

import numpy as np

from spr_pick_tpu_torch.data.folder import UnlabelledImageFolderDataset


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_dir")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--recursive", action="store_true", default=True)
    args = p.parse_args(argv)

    try:
        import h5py
    except ImportError:
        raise SystemExit("h5py is required to write HDF5 datasets")

    ds = UnlabelledImageFolderDataset(args.image_dir, recursive=args.recursive)
    n = len(ds)
    shapes = [ds.image_size(i) for i in range(n)]
    hmax = max(h for h, _ in shapes)
    wmax = max(w for _, w in shapes)

    with h5py.File(args.output, "w") as f:
        images = f.create_dataset(
            "images", (n, hmax, wmax), dtype=np.float32, compression="gzip"
        )
        f.create_dataset("shapes", data=np.asarray(shapes, np.int32))
        names = f.create_dataset("names", (n,), dtype=h5py.string_dtype())
        for i in range(n):
            img = ds[i]
            images[i, : img.shape[0], : img.shape[1]] = img
            names[i] = ds.name(i)
    print(f"wrote {n} images ({hmax}x{wmax} max) -> {args.output}")


if __name__ == "__main__":
    main()
