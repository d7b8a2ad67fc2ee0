"""Device resolution, numerics and host copies shared by the port's entry
points."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.tree import tree_leaves, tree_map


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


class HostCopy:
    """A tree of tensors (nested dicts) copied to the host as it stands at
    this point of the current stream, without waiting for the card.

    On CUDA each leaf is copied with ``non_blocking=True`` into pinned
    memory and an event is recorded after the copies; :meth:`wait` waits
    on that event alone, so work enqueued after the copy (the next
    segment of a pipelined run) keeps the card busy while the host reads. On
    the CPU each leaf is cloned: the copy is taken now, and a later
    in-place write to the tensor (the segment engine's static buffers)
    leaves it as it was.
    """

    def __init__(self, tree):
        self._event = None
        cuda = [leaf.device for leaf in tree_leaves(tree) if leaf.is_cuda]
        if not cuda:
            self._tree = tree_map(torch.clone, tree)
            return

        def copy(leaf):
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            return host.copy_(leaf, non_blocking=True)

        self._tree = tree_map(copy, tree)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(cuda[0]))

    def wait(self):
        """The tree of CPU tensors, once the copies have landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._tree
