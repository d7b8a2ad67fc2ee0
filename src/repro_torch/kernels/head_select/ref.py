"""Plain PyTorch version of the fused k-head cross-entropy (FACADE step
2c), the counterpart of ``repro/kernels/head_select/ref.py`` with a
leading node axis. The CUDA kernel is held against it."""
from __future__ import annotations

import torch


def head_losses_ref(features, heads, labels) -> torch.Tensor:
    """features [n, T, D], heads [n, K, D, V], labels [n, T] (< 0 excluded)
    -> [n, K] fp32 mean NLL per node and head over the valid tokens."""
    n, k = heads.shape[:2]
    t = features.shape[1]
    logits = torch.einsum("ntd,nkdv->nktv", features.float(), heads.float())
    lse = torch.logsumexp(logits, dim=-1)                      # [n, k, t]
    labs = labels.long().clamp(min=0)[:, None, :, None].expand(n, k, t, 1)
    gold = torch.gather(logits, -1, labs).squeeze(-1)
    valid = (labels >= 0)[:, None, :]
    nll = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return nll.sum(dim=-1) / valid.sum(dim=-1).clamp(min=1)
