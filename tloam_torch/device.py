"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one. With no GPU and no explicit request this raises instead of sliding
    to the CPU, so a run that was meant for the card never measures the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tloam_torch: no CUDA device is available; pass device='cpu' to "
            "run on the CPU"
        )
    return torch.device("cuda")
