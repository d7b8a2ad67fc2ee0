"""Layers of the paper's CNNs as plain functions on tensors.

Mirrors ``repro.models.layers`` for what GN-LeNet needs. Norms and losses
accumulate in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32) / math.sqrt(d_in)
    return w.to(dtype)


def group_norm_nchw(x, gamma, beta, groups: int, eps: float = 1e-5):
    """GroupNorm of ``[B, C, H, W]``: per sample and group, stats over the
    group's channels and H, W (biased variance)."""
    out = F.group_norm(x.float(), groups, gamma.float(), beta.float(), eps)
    return out.to(x.dtype)


def group_norm(x, gamma, beta, groups: int, eps: float = 1e-5):
    """GroupNorm over the channel (last) axis of NHWC activations, as the
    reference defines it: stats over (H, W, channels-in-group)."""
    y = group_norm_nchw(x.permute(0, 3, 1, 2), gamma, beta, groups, eps)
    return y.permute(0, 2, 3, 1)


def nll(logits, labels):
    """Per-position negative log-likelihood in fp32; logits [..., V]."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return lse - gold


def softmax_xent(logits, labels, mask=None):
    """Standard CE; logits [..., V], labels int, mask float."""
    loss = nll(logits, labels)
    if mask is None:
        return loss.mean()
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
