"""Device resolution and numerics shared by the port's entry points."""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def no_tf32():
    """fp32 matmuls and convolutions in full fp32, as the reference
    computes them: TF32 off for cuBLAS and cuDNN inside the block (PyTorch
    leaves cuDNN's on by default), the caller's flags restored after it,
    also on an exception."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@contextlib.contextmanager
def deterministic():
    """cuDNN restricted to deterministic algorithms inside the block
    (``cudnn.deterministic`` on, ``cudnn.benchmark`` off, so no timed
    algorithm search either), the caller's flags restored after it, also
    on an exception. The segment engine's replays and the per-round loop
    then run the same convolution algorithms, none of which accumulates
    in a run-dependent order, so a run repeats bit for bit."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
