"""Noise2Void uniform-pixel-selection (UPS) masking.

The PyTorch port's copy of `spr_pick_tpu/data/n2v.py` (parity:
`spr_pick/utils/n2v_ups.py:7-97`): stratified-grid pixel replacement giving
(manipulated image, dense 0/1 mask), with the lower patch bound taken by
max() (the reference's ``min(x - r, 0)`` is inverted; SURVEY.md §7.4).

`stratified_coords` and `manipulate` are the numpy host plane, drawing the
same numbers from the same `RandomState` as the JAX package's.
`manipulate_torch` is the batched counterpart of `manipulate_jax`
(:65-131) for the data plane on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

PERC_PIX = 1.5  # percentage of pixels manipulated (n2v_ups.py:72)
BOX = int(np.round(np.sqrt(100.0 / PERC_PIX)))  # stratified grid cell: 8


def stratified_coords(shape, rng: np.random.RandomState
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One random coordinate per box of a sqrt(100/perc)-sized grid."""
    box_size = BOX
    box_count_y = int(np.ceil(shape[0] / box_size))
    box_count_x = int(np.ceil(shape[1] / box_size))
    ys, xs = [], []
    for i in range(box_count_y):
        for j in range(box_count_x):
            y = int(i * box_size + rng.rand() * box_size)
            x = int(j * box_size + rng.rand() * box_size)
            if y < shape[0] and x < shape[1]:
                ys.append(y)
                xs.append(x)
    return np.asarray(ys), np.asarray(xs)


def manipulate(image: np.ndarray, subpatch_size: int = 5,
               rng: np.random.RandomState = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """UPS replacement: each selected pixel takes the value of a random
    *different* pixel within its subpatch.  `image` is (H, W); returns
    (manipulated copy, 0/1 mask of replaced pixels)."""
    if subpatch_size % 2 == 0:
        raise ValueError("subpatch_size must be odd")
    rng = rng or np.random
    h, w = image.shape[:2]
    out = image.copy()
    mask = np.zeros((h, w), dtype=np.float32)
    radius = subpatch_size // 2

    ys, xs = stratified_coords((h, w), rng)
    for y, x in zip(ys, xs):
        y0, y1 = max(y - radius, 0), min(y + radius, h - 1)
        x0, x1 = max(x - radius, 0), min(x + radius, w - 1)
        # draw a donor pixel != (y, x)
        for _ in range(16):
            ry = rng.randint(y0, y1 + 1)
            rx = rng.randint(x0, x1 + 1)
            if ry != y or rx != x:
                break
        out[y, x] = image[ry, rx]
        mask[y, x] = 1.0
    return out, mask


def grid_shape(h: int, w: int) -> Tuple[int, int]:
    """(by, bx): the stratified grid's cells over an (h, w) image."""
    return -(-h // BOX), -(-w // BOX)


def manipulate_torch(images: torch.Tensor,
                     u_y: Optional[torch.Tensor] = None,
                     u_x: Optional[torch.Tensor] = None,
                     u_donor: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     subpatch_size: int = 5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched UPS on the device, the operations of `manipulate_jax`.

    ``images``: (B, H, W).  One target per cell of the 8x8 grid, at
    ``int(g * 8 + u * 8)`` in float32 (the JAX order of operations, so a
    draw near a cell edge lands in the same pixel), replaced by a pixel
    drawn uniformly from the other pixels of its clipped
    ``subpatch_size``-square window.  ``u_y``, ``u_x``, ``u_donor`` are
    (B, by, bx) uniforms in [0, 1) (`grid_shape`); those not given come
    from ``generator``, in that order.  Cells past H or W (sizes not a
    multiple of 8) are dropped, as JAX's ``mode="drop"`` scatter drops
    them: they are written to an extra row that is cut off.  Returns
    (manipulated, 0/1 mask), each (B, H, W).
    """
    if subpatch_size % 2 == 0:
        raise ValueError("subpatch_size must be odd")
    b, h, w = images.shape
    by, bx = grid_shape(h, w)
    dev = images.device
    radius = subpatch_size // 2

    def uniform(u):
        if u is None:
            u = torch.rand((b, by, bx), generator=generator, device=dev)
        return u

    u_y, u_x, u_donor = uniform(u_y), uniform(u_x), uniform(u_donor)
    gi = torch.arange(by, dtype=torch.float32, device=dev)[:, None]
    gj = torch.arange(bx, dtype=torch.float32, device=dev)[None, :]
    ys = (gi * BOX + u_y * BOX).to(torch.int32)
    xs = (gj * BOX + u_x * BOX).to(torch.int32)
    valid = (ys < h) & (xs < w)

    # Clipped donor window around each target (n2v_ups.py:40-47 with the
    # max/min bound fix).
    y0 = torch.clamp(ys - radius, min=0)
    y1 = torch.clamp(ys + radius, max=h - 1)
    x0 = torch.clamp(xs - radius, min=0)
    x1 = torch.clamp(xs + radius, max=w - 1)
    hy = torch.clamp(y1 - y0 + 1, min=1)
    hx = torch.clamp(x1 - x0 + 1, min=1)
    n = hy * hx
    target = (ys - y0) * hx + (xs - x0)
    # Uniform over the n - 1 other window pixels: draw in [0, n - 1), then
    # step over the target's index.
    idx = torch.minimum((u_donor * (n - 1)).to(torch.int32), n - 2)
    idx = idx + (idx >= target).to(torch.int32)
    idx = torch.minimum(torch.clamp(idx, min=0), n - 1)
    dy = torch.clamp(y0 + torch.div(idx, hx, rounding_mode="floor"),
                     0, h - 1).long()
    dx = torch.clamp(x0 + torch.remainder(idx, hx), 0, w - 1).long()
    item = torch.arange(b, device=dev)[:, None, None].expand(b, by, bx)
    donor = images[item, dy, dx]

    # Dropped cells go to row h of a (B, H + 1, W) buffer.
    rows = torch.where(valid, ys, torch.full_like(ys, h)).long()
    cols = torch.clamp(xs, max=w - 1).long()
    spare = images.new_zeros((b, 1, w))
    out = torch.cat([images, spare], dim=1)
    out[item, rows, cols] = donor
    mask = torch.zeros((b, h + 1, w), dtype=torch.float32, device=dev)
    # A device scalar: a Python one would be copied from the host, which a
    # CUDA graph cannot capture.
    mask[item, rows, cols] = torch.ones((), device=dev)
    return out[:, :h], mask[:, :h]
