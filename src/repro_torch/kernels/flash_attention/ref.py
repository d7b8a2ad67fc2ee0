"""Plain PyTorch version of blocked causal GQA attention, the port's copy
of ``repro/kernels/flash_attention/ref.py::attention_ref`` (same layout,
``[B, H, S, D]``). The CUDA kernel is held against it."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q [B,Hq,S,D], k/v [B,Hkv,S,D] -> [B,Hq,S,D]. fp32 softmax."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)

    qg = q.reshape(b, hkv, g, s, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)
    return out.reshape(b, hq, s, d)
