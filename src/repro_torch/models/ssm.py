"""Selective SSM (Mamba-style) branch of the hymba hybrid architecture
(mirrors ``repro.models.ssm``).

Hymba [arXiv:2411.13676] runs attention heads and mamba heads in parallel
within each layer and fuses their (per-branch normalised) outputs. This
module is the mamba branch:

    x -> in_proj -> (u, z); u -> causal depthwise conv -> silu
    dt, B, C = proj(u);  h_t = exp(A*dt_t) . h_{t-1} + dt_t * (B_t  u_t)
    y_t = (h_t C_t) + D . u_t;  out = (y * silu(z)) @ out_proj

The state is ``[B, d_inner, N]`` (N = ``ssm_state``) in fp32. The
selective scan is a plain PyTorch loop over time, one ``addcmul`` a step
(the reference's ``lax.scan``; it has no Pallas kernel). The reference
cuts long sequences into rematerialised chunks for its backward pass;
the recurrence is the same, so one loop serves both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import localmap, scan_ops

from . import layers
from .base import ModelConfig


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def init_ssm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """``dt_bias``, ``a_log`` and ``d_skip`` are fp32 in any model dtype,
    as the reference's."""
    di, n = d_inner(cfg), cfg.ssm_state
    dev = generator.device
    dt_rank = max(1, cfg.d_model // 16)
    w_in = layers.dense_init(generator, cfg.d_model, 2 * di, cfg.dt)
    conv_w = (torch.randn((cfg.ssm_conv, di), generator=generator,
                          dtype=torch.float32, device=dev) * 0.1).to(cfg.dt)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "w_xproj": layers.dense_init(generator, di, dt_rank + 2 * n, cfg.dt),
        "w_dt": layers.dense_init(generator, dt_rank, di, cfg.dt),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=dev),
        # A stored as log of negated continuous-time decay
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev)).expand(di, n).clone(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": layers.dense_init(generator, di, cfg.d_model, cfg.dt),
    }


def _dbc(cfg: ModelConfig, p, u):
    """u [..., di] -> dt [..., di], b [..., N], c [..., N], all fp32: the
    projection in the param dtype, widened, then ``softplus``."""
    n = cfg.ssm_state
    dt_rank = p["w_dt"].shape[0]
    proj = (u @ p["w_xproj"]).float()
    dt_r, b, c = proj.split([dt_rank, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["w_dt"].float() + p["dt_bias"])
    return dt, b, c


def _conv_causal(p, u, conv_cache=None):
    """Depthwise causal conv over time in the param dtype. u [B,S,di].
    With ``conv_cache`` (decode: the last ``kw - 1`` inputs) it also
    returns the next cache."""
    w = p["conv_w"]
    kw = w.shape[0]
    if conv_cache is None and localmap.is_dtensor(u):
        # per channel: each rank convolves its batch rows and channels
        lm = localmap
        u = lm.settle(u, (0, 2), "ssm conv input")
        w = lm.like(w, u, {2: 1})
        out = lm.on_shards(lambda ul, wl: _conv_causal({"conv_w": wl},
                                                       ul)[0],
                           (u, w), tuple(u.placements))
        return out, None
    if conv_cache is not None:
        window = torch.cat([conv_cache, u], dim=1)           # [B,kw,di]
        out = torch.einsum("bkd,kd->bd", window, w)[:, None, :]
        return out, window[:, 1:]
    up = F.pad(u, (0, 0, kw - 1, 0))
    win = up.unfold(1, kw, 1)                                # [B,S,di,kw]
    return torch.einsum("bsdk,kd->bsd", win, w), None


def ssm_scan(cfg: ModelConfig, p, u, h0=None):
    """Selective scan. u [B,S,di] -> (y [B,S,di] in u's dtype, h_final
    [B,di,N] fp32)."""
    b, _, di = u.shape
    h = (torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32,
                     device=u.device) if h0 is None else h0)
    a = -torch.exp(p["a_log"])                               # [di,N]
    dt, bb, cc = _dbc(cfg, p, u)
    uf = u.float()
    da = torch.exp(dt[..., None] * a)                        # [B,S,di,N]
    dbu = dt[..., None] * bb[:, :, None, :] * uf[..., None]  # [B,S,di,N]
    hs, h = _scan(da, dbu, h)
    y = torch.einsum("bsdn,bsn->bsd", hs, cc) + uf * p["d_skip"]
    return y.to(u.dtype), h


def _scan(da, dbu, h):
    """The loop (its one-op stand-in on fake tensors); on DTensors on each
    rank's batch rows and channels."""
    if localmap.any_dtensor(da, dbu, h):
        from torch.distributed.tensor import Shard
        lm = localmap
        ref = next(x for x in (da, dbu) if lm.is_dtensor(x))
        ref = lm.settle(ref, (0, 2), "ssm scan")
        da, dbu = (lm.like(x, ref, {0: 0, 2: 2}) for x in (da, dbu))
        h = lm.like(h, ref, {0: 0, 2: 1})
        h_pl = tuple(Shard(1) if isinstance(pl, Shard) and pl.dim == 2
                     else pl for pl in da.placements)
        return lm.on_shards(_scan, (da, dbu, h),
                            (tuple(da.placements), h_pl))
    scan = _SCAN_OP if scan_ops.is_fake(da) else _scan_loop
    return scan(da, dbu, h)


def _scan_loop(da, dbu, h):
    """``h_t = da_t h_{t-1} + dbu_t`` over S: (every h_t stacked [B,S,di,N],
    the last)."""
    hs = []
    for t in range(da.shape[1]):
        h = torch.addcmul(dbu[:, t], da[:, t], h)
        hs.append(h)
    return (torch.stack(hs, dim=1) if hs else dbu.new_zeros(dbu.shape)), h


# elementwise only: FlopCounterMode counts 0 for the loop and its backward
_SCAN_OP = scan_ops.define(
    "ssm_scan", ("da", "dbu", "h0"), 2, _scan_loop,
    lambda da, dbu, h0: (torch.empty_like(dbu), torch.empty_like(h0)))


def ssm_branch(cfg: ModelConfig, p, x):
    """Full-sequence mamba branch. x [B,S,D] -> (out [B,S,D], the final
    state h [B,di,N], the pre-conv u [B,S,di] whose last ``ssm_conv - 1``
    positions are the decode cache's conv window)."""
    u_in, z = (x @ p["w_in"]).chunk(2, dim=-1)
    u, _ = _conv_causal(p, u_in)
    u = F.silu(u.float()).to(x.dtype)
    y, h = ssm_scan(cfg, p, u)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ p["w_out"], h, u_in


def ssm_forward(cfg: ModelConfig, p, x):
    """Full-sequence mamba branch. x [B,S,D] -> [B,S,D]."""
    return ssm_branch(cfg, p, x)[0]


def ssm_init_cache(cfg: ModelConfig, batch: int, device) -> dict:
    di, n = d_inner(cfg), cfg.ssm_state
    return {
        "h": torch.zeros((batch, di, n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=cfg.dt,
                            device=device),
    }


def conv_tail(cfg: ModelConfig, u):
    """The decode cache's conv window after a prefill of pre-conv ``u``
    [B,S,di]: its last ``ssm_conv - 1`` positions, zero-padded in front
    when S is shorter."""
    kw1 = cfg.ssm_conv - 1
    if localmap.is_dtensor(u):
        # on each rank's batch rows and channels, S whole: the card's
        # DTensor (torch 2.11) lays out a padded DTensor over one mesh dim
        # where its mesh has two
        u = localmap.settle(u, (0, 2), "ssm conv tail")
        return localmap.on_shards(lambda ul: conv_tail(cfg, ul), (u,),
                                  tuple(u.placements))
    return F.pad(u, (0, 0, kw1, 0))[:, -kw1:]


def ssm_decode(cfg: ModelConfig, p, x, cache):
    """One-token step. x [B,1,D] -> (out [B,1,D], new cache)."""
    u, z = (x @ p["w_in"]).chunk(2, dim=-1)
    u, conv = _conv_causal(p, u, conv_cache=cache["conv"])
    u = F.silu(u.float()).to(x.dtype)
    dt, bb, cc = _dbc(cfg, p, u[:, 0])
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[..., None] * a)
    uf = u[:, 0].float()
    h = da * cache["h"] + dt[..., None] * bb[:, None, :] * uf[..., None]
    y = torch.einsum("bdn,bn->bd", h, cc) + uf * p["d_skip"]
    y = y.to(x.dtype)[:, None, :]
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ p["w_out"], {"h": h, "conv": conv}
