"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller names another device. Without
a GPU they raise: there is no silent fallback to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
