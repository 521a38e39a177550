"""K1's tiling on the CPU: the tile edge the wrapper chooses, the shared
memory it budgets, and the views the kernel reads in place.  (The kernel
itself runs only on the card: tests/test_torch_cuda.py.)"""

import numpy as np
import pytest
import torch

from spr_pick_tpu.ops.nms import non_maximum_suppression_np as jax_oracle
from spr_pick_tpu_torch.ops import nms_cuda

H100_SMEM_OPTIN = 232448  # bytes a block may opt in to on an H100


@pytest.mark.parametrize("shape, edge", [
    ((1024, 1024), 32),    # the main path: 1024 tiles, 8 KB
    ((4096, 5760), 32),    # a full micrograph: 23040 tiles, 186 KB
    ((8192, 8192), 64),
    ((16384, 16384), 128),
    ((58044, 16384), 256),  # the tallest map the row-max design took
    ((5, 7), 32),
    ((1, 300), 32),
])
def test_tile_edge(shape, edge):
    assert nms_cuda.tile_edge(*shape, 15, H100_SMEM_OPTIN) == edge
    assert nms_cuda.smem_bytes(*shape, 15, edge) <= H100_SMEM_OPTIN


def test_smem_budget():
    # Tiles, groups of 32 tiles, and 4 chunk keys for each tile of the
    # disk's box (T = 32 or 64).
    assert nms_cuda.smem_bytes(1024, 1024, 15, 32) == 8 * (1024 + 32 + 4 * 4)
    assert nms_cuda.smem_bytes(4096, 5760, 15, 32) == 8 * (23040 + 720 + 16)
    assert nms_cuda.smem_bytes(8192, 8192, 15, 64) == 8 * (16384 + 512 + 16)
    # r = 40 spans up to 4 x 4 tiles of 32; a map of one tile caps the box.
    assert nms_cuda.smem_bytes(1024, 1024, 40, 32) == 8 * (1024 + 32 + 64)
    assert nms_cuda.smem_bytes(5, 7, 40, 32) == 8 * (1 + 1 + 4)
    # A radius whose box needs more chunks can take a larger tile.
    assert nms_cuda.tile_edge(4096, 5760, 15, 190208) == 32
    assert nms_cuda.tile_edge(4096, 5760, 17, 190208) == 64


@pytest.mark.parametrize("radius, edge", [(0, 32), (40, 32), (64, 32),
                                          (65, 64), (512, 256)])
def test_tile_edge_keeps_the_box_within_32_tiles(radius, edge):
    assert nms_cuda.tile_edge(8000, 8000, radius, 1 << 30) == edge


def test_tile_edge_refuses_past_the_limit():
    with pytest.raises(ValueError, match="232448 bytes"):
        nms_cuda.tile_edge(65536, 65536, 15, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="radius 513"):
        nms_cuda.tile_edge(8000, 8000, 513, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="65536 pixels a side"):
        nms_cuda.tile_edge(1, 70000, 15, H100_SMEM_OPTIN)


def test_check_view_takes_the_crop():
    # Picker._heatmaps passes outputs[DETECT][:, :h, :w, 0].
    full = torch.zeros(2, 96, 128, 1)
    crop = full[:, :90, :100, 0]
    assert crop.stride() == (96 * 128, 128, 1)
    nms_cuda._check_view(crop)
    # One column: its stride is never used.
    nms_cuda._check_view(torch.zeros(2, 3, 5).transpose(1, 2)[:, :, :1])


def test_check_view_refuses_a_transposed_view():
    with pytest.raises(ValueError, match="unit column stride"):
        nms_cuda._check_view(torch.zeros(1, 8, 9).transpose(1, 2))
    with pytest.raises(ValueError, match="unit column stride"):
        nms_cuda._check_view(torch.zeros(1, 8, 18)[:, :, ::2])


def test_plain_version_on_the_crop_matches_the_oracle():
    rng = np.random.RandomState(7)
    full = torch.from_numpy(rng.rand(2, 96, 128, 1).astype(np.float32))
    crop = full[:, :90, :100, 0]
    s, c, n = nms_cuda.greedy_nms(crop, 6, 0.1, 4096)
    for i in range(2):
        s_ref, c_ref = jax_oracle(crop[i].numpy(), 6, threshold=0.1)
        np.testing.assert_array_equal(s[i, :n[i]].numpy(), s_ref)
        np.testing.assert_array_equal(c[i, :n[i]].numpy(), c_ref)
