"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev
