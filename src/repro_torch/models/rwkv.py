"""RWKV-6 "Finch" blocks [arXiv:2404.05892] — attention-free, data-dependent
decay linear recurrence (mirrors ``repro.models.rwkv``).

Per head (head_dim = d/H) the time-mixing state is the matrix
``S in R^{hd x hd}``:

    wkv_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t

with the data-dependent per-channel decay ``w_t = exp(-exp(wb + lora(x_t)))``.
Over a full sequence from a zero state (prefill, forward, training) the
recurrence goes through ``kernels/rwkv6.wkv_train``: its forward is the
hand-written kernel on the card (the plain ``wkv_scan`` on the CPU), and
under autograd its backward is the hand-written backward kernel on the
card (``wkv_backward``: the state kept at each chunk's start, a chunk's
states recomputed, then walked back) and autograd through the plain
``wkv_scan`` on the CPU. With a carried state (decode, one step) it is
the plain ``wkv_scan``, as the reference's decode is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import wkv_scan, wkv_train
from repro_torch.localmap import merge_last, split_last

from . import layers
from .base import ModelConfig

HEAD_DIM = 64


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def init_time_mix(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = n_heads(cfg)
    lora = 32
    dev = generator.device

    def full(value, dtype=cfg.dt):
        return torch.full((d,), value, dtype=dtype, device=dev)

    return {
        # token-shift interpolation coefficients per stream
        "mu_r": full(0.5),
        "mu_k": full(0.5),
        "mu_v": full(0.5),
        "mu_w": full(0.5),
        "mu_g": full(0.5),
        "w_r": layers.dense_init(generator, d, d, cfg.dt),
        "w_k": layers.dense_init(generator, d, d, cfg.dt),
        "w_v": layers.dense_init(generator, d, d, cfg.dt),
        "w_g": layers.dense_init(generator, d, d, cfg.dt),
        # data-dependent decay: w = exp(-exp(base + lora))
        "decay_base": full(-1.0, torch.float32),
        "w_dec1": layers.dense_init(generator, d, lora, cfg.dt),
        "w_dec2": layers.dense_init(generator, lora, d, cfg.dt),
        "bonus_u": torch.randn((h, HEAD_DIM), generator=generator,
                               dtype=torch.float32, device=dev) * 0.1,
        "ln_g": full(1.0),  # per-head group norm gamma
        "w_o": layers.dense_init(generator, d, d, cfg.dt),
    }


def init_channel_mix(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dev = generator.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=cfg.dt, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=cfg.dt, device=dev),
        "w_k": layers.dense_init(generator, d, ff, cfg.dt),
        "w_v": layers.dense_init(generator, ff, d, cfg.dt),
        "w_r": layers.dense_init(generator, d, d, cfg.dt),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} stream. x [B,S,D]; last [B,D] for decode."""
    if last is not None:
        return last[:, None, :]
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _mix(x, xp, mu):
    return x * mu + xp * (1.0 - mu)


def _decay(p, xw):
    dd = xw @ p["w_dec1"]
    dd = torch.tanh(dd.float()).to(xw.dtype) @ p["w_dec2"]
    return torch.exp(-torch.exp(p["decay_base"] + dd.float()))


def _heads(x, h):
    return split_last(x, h, x.shape[-1] // h)


def time_mix(cfg: ModelConfig, p, x, state=None, last_x=None):
    """state: [B,H,hd,hd] or None; last_x [B,D] (decode) or None.
    Returns (out [B,S,D], final state, last input row [B,D])."""
    h = n_heads(cfg)
    xp = _shift(x, last_x)
    r = _heads(_mix(x, xp, p["mu_r"]) @ p["w_r"], h).float()
    k = _heads(_mix(x, xp, p["mu_k"]) @ p["w_k"], h).float()
    v = _heads(_mix(x, xp, p["mu_v"]) @ p["w_v"], h).float()
    g = _mix(x, xp, p["mu_g"]) @ p["w_g"]
    w = _heads(_decay(p, _mix(x, xp, p["mu_w"])), h)  # fp32 in (0,1)
    k = k / HEAD_DIM ** 0.5

    if state is None:
        # the kernel takes contiguous rows only; the function keeps these
        y, sf = wkv_train(r.contiguous(), k.contiguous(), v.contiguous(),
                          w.contiguous(), p["bonus_u"])
    else:
        y, sf = wkv_scan(r, k, v, w, p["bonus_u"], s0=state)
    b, s = x.shape[:2]
    # per-head group norm (biased variance, as jnp.var)
    yn = y.reshape(b, s, h, HEAD_DIM)
    mu = yn.mean(-1, keepdim=True)
    var = yn.var(-1, keepdim=True, unbiased=False)
    yn = (yn - mu) * torch.rsqrt(var + 64e-5)
    y = (merge_last(yn) * p["ln_g"].float()).to(x.dtype)
    y = y * F.silu(g.float()).to(x.dtype)
    return y @ p["w_o"], sf, x[:, -1, :]


def channel_mix(cfg: ModelConfig, p, x, last_x=None):
    xp = _shift(x, last_x)
    k = _mix(x, xp, p["mu_k"]) @ p["w_k"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    r = torch.sigmoid((_mix(x, xp, p["mu_r"]) @ p["w_r"]).float())
    return (k @ p["w_v"]) * r.to(x.dtype), x[:, -1, :]


def rwkv_init_cache(cfg: ModelConfig, batch: int, device) -> dict:
    h = n_heads(cfg)
    return {
        "s": torch.zeros((batch, h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                         device=device),
        "tm_x": torch.zeros((batch, cfg.d_model), dtype=cfg.dt,
                            device=device),
        "cm_x": torch.zeros((batch, cfg.d_model), dtype=cfg.dt,
                            device=device),
    }
