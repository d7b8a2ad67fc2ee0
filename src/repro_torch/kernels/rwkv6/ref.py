"""Plain PyTorch version of the RWKV6 wkv recurrence: the port's copy of
``repro.models.rwkv.wkv_scan`` (the reference kernel's oracle). The CUDA
kernel is held against it, and the model's decode step runs it.

``wkv_backward_scan`` is its gradient as an explicit reverse recurrence
in the backward kernel's chunked order, for the tests and the card's
checks; nothing on the card's path runs it."""
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


def wkv_backward_scan(r, k, v, w, u, grad_y, grad_s=None, chunk: int = 16):
    """The gradients (dr, dk, dv, dw, du) of ``wkv_scan(r, k, v, w, u)``'s
    ``(y, S_final)`` from a zero state for output gradients ``grad_y``
    [B,S,H,hd] and ``grad_s`` [B,H,hd,hd] (either None: a zero gradient),
    in the order of ``csrc/wkv_backward.cu``: a forward sweep keeps the
    state at the start of each chunk of ``chunk`` steps; then chunk by
    chunk from the last, the chunk's states are recomputed from its start
    and walked back, with ``dS`` the gradient of ``S_t``:

        dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u_i k_t[i] a_t
        dk_t[i] = sum_j dS[i,j] v_t[j] + r_t[i] u_i a_t
        dv_t[j] = sum_i dS[i,j] k_t[i] + b_t dy_t[j]
        dw_t[i] = sum_j dS[i,j] S_{t-1}[i,j];  du_i += r_t[i] k_t[i] a_t
        dS <- diag(w_t) dS + r_t^T dy_t

    with ``a_t = dy_t . v_t`` and ``b_t = sum_i r_t[i] u_i k_t[i]``."""
    b, s, h, hd = r.shape
    gy = torch.zeros_like(r) if grad_y is None else grad_y

    def advance(state, t):
        return (w[:, t, :, :, None] * state
                + k[:, t, :, :, None] * v[:, t, :, None, :])

    starts, state = [], r.new_zeros((b, h, hd, hd))
    for t0 in range(0, s, chunk):
        starts.append(state)
        for t in range(t0, min(t0 + chunk, s)):
            state = advance(state, t)
    ds = r.new_zeros((b, h, hd, hd)) if grad_s is None else grad_s
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = r.new_zeros((h, hd))
    for c in reversed(range(len(starts))):
        t0 = c * chunk
        states = [starts[c]]                 # states[i] = S_{t0 + i - 1}
        for t in range(t0, min(t0 + chunk, s) - 1):
            states.append(advance(states[-1], t))
        for i in reversed(range(len(states))):
            t, prev = t0 + i, states[i]
            r_t, k_t, v_t, w_t, g_t = (x[:, t] for x in (r, k, v, w, gy))
            a = (g_t * v_t).sum(-1, keepdim=True)
            bonus = (r_t * u * k_t).sum(-1, keepdim=True)
            dr[:, t] = (torch.einsum("bhij,bhj->bhi", prev, g_t)
                        + u * k_t * a)
            dk[:, t] = torch.einsum("bhij,bhj->bhi", ds, v_t) + r_t * u * a
            dv[:, t] = torch.einsum("bhij,bhi->bhj", ds, k_t) + bonus * g_t
            dw[:, t] = (ds * prev).sum(-1)
            du = du + (r_t * k_t * a).sum(0)
            ds = w_t[..., None] * ds + r_t[..., None] * g_t[..., None, :]
    return dr, dk, dv, dw, du


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
