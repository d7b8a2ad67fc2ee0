"""Plain PyTorch version of the RWKV6 wkv recurrence: the port's copy of
``repro.models.rwkv.wkv_scan`` (the reference kernel's oracle). The CUDA
kernel is held against it, and the model's decode step runs it."""
from __future__ import annotations

import torch


def wkv_scan(r, k, v, w, u, s0=None):
    """Linear recurrence. r,k,v,w [B,S,H,hd] fp32; u [H,hd]; s0 [B,H,hd,hd]
    or None (zeros). Returns (y [B,S,H,hd], S_final [B,H,hd,hd]):
    ``y_t = r_t (S + diag(u) k_t^T v_t)``, then
    ``S <- diag(w_t) S + k_t^T v_t``.

    The reference processes the sequence in rematerialized chunks for its
    backward pass; the forward values are those of this one loop."""
    b, s, h, hd = r.shape
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=r.device) if s0 is None else s0)
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[:, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(v)
    return y, state
