"""Plain PyTorch version of the RWKV6 wkv recurrence: the port's copy of
``repro.models.rwkv.wkv_scan`` (the reference kernel's oracle). The CUDA
kernel is held against it, and the model's decode step runs it."""
from __future__ import annotations

import torch

from repro_torch import scan_ops


def wkv_scan(r, k, v, w, u, s0=None):
    """Linear recurrence. r,k,v,w [B,S,H,hd] fp32; u [H,hd]; s0 [B,H,hd,hd]
    or None (zeros). Returns (y [B,S,H,hd], S_final [B,H,hd,hd]):
    ``y_t = r_t (S + diag(u) k_t^T v_t)``, then
    ``S <- diag(w_t) S + k_t^T v_t``.

    The reference processes the sequence in rematerialized chunks for its
    backward pass; the forward values are those of this one loop. On fake
    tensors the loop traces as one op (``scan_ops``)."""
    b, _, h, hd = r.shape
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=r.device) if s0 is None else s0)
    if scan_ops.is_fake(r):
        return _WKV_OP(r, k, v, w, u, state)
    return _wkv_loop(r, k, v, w, u, state)


def _wkv_loop(r, k, v, w, u, state):
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[:, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(v)
    return y, state


def _wkv_flops(r, *_):
    """What ``FlopCounterMode`` counts for the loop: its einsum, one
    ``[hd] x [hd, hd]`` product a step, (B, S, H) = r's first dims."""
    b, s, h, hd = r
    return 2 * b * s * h * hd * hd


_WKV_OP = scan_ops.define(
    "wkv_scan", ("r", "k", "v", "w", "u", "s0"), 2, _wkv_loop,
    lambda r, k, v, w, u, s0: (torch.empty_like(r), torch.empty_like(s0)),
    fwd_flops=_wkv_flops,
    bwd_flops=lambda *shapes: 2 * _wkv_flops(*shapes))
