"""Per-node batch sampling for the DL training loop, and eval batching.

``sample_round_batches`` gathers, for every node, H local-step batches of
size B (paper: H = tau local steps on batches of B = 8), stacked
``[n, H, B, ...]`` so one round consumes the whole round's data;
``sample_round_token_batches`` does the same for token streams. The
indices are an input: the port's own runs draw them with
:func:`draw_batch_indices`, and the tests replay the reference's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod


def place(dataset, device="cuda"):
    """The node-stacked train arrays as tensors on ``device``:
    ``(train_x [n, N, H, W, C] float, train_y [n, N] int64)``."""
    dev = device_mod.resolve(device)
    return (torch.from_numpy(dataset.train_x).to(dev),
            torch.from_numpy(dataset.train_y).long().to(dev))


def draw_batch_indices(generator: torch.Generator, n: int, h: int, b: int,
                       per_node: int) -> torch.Tensor:
    """Uniform ``[n, H, B]`` sample indices into each node's N samples,
    drawn with replacement, on the generator's device."""
    return torch.randint(0, per_node, (n, h, b), generator=generator,
                         device=generator.device)


def sample_round_batches(idx, train_x, train_y) -> dict:
    """idx [n, H, B]; train_x [n, N, ...], train_y [n, N] ->
    ``{"x": [n, H, B, ...], "y": [n, H, B]}``."""
    n, h, b = idx.shape
    rows = torch.arange(n, device=idx.device)[:, None]
    flat = idx.reshape(n, h * b)
    return {"x": train_x[rows, flat].reshape((n, h, b) + train_x.shape[2:]),
            "y": train_y[rows, flat].reshape(n, h, b)}


def sample_round_token_batches(idx, train_tokens) -> dict:
    """idx [n, H, B]; train_tokens [n, N, S] -> next-token batches
    ``{"tokens", "labels", "mask"}``, each ``[n, H, B, S-1]`` (mask fp32
    ones)."""
    n, h, b = idx.shape
    rows = torch.arange(n, device=idx.device)[:, None]
    g = train_tokens[rows, idx.reshape(n, h * b)].reshape(
        n, h, b, train_tokens.shape[-1])
    return {"tokens": g[..., :-1], "labels": g[..., 1:],
            "mask": torch.ones(g[..., 1:].shape, dtype=torch.float32,
                               device=g.device)}


def padded_eval_batches(x: np.ndarray, batch: int):
    """[N, ...] -> (batches [nb, B, ...], mask [nb, B] float32).

    The trailing partial batch is zero-padded and masked out, so every
    eval batch has one shape.
    """
    x = np.asarray(x)
    n = x.shape[0]
    nb = max(1, -(-n // batch))
    pad = nb * batch - n
    mask = np.ones((n,), np.float32)
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        mask = np.concatenate([mask, np.zeros((pad,), np.float32)])
    return (x.reshape((nb, batch) + x.shape[1:]), mask.reshape(nb, batch))
