"""The port's device rule: entry points run on the GPU unless the caller
asks for another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the GPU, raising when there is none; else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
