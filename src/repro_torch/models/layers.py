"""Common layers as plain functions on tensors (init + apply).

Mirrors ``repro.models.layers`` for what GN-LeNet and the language models
need. Params are nested dicts of tensors; every ``*_init`` draws from an
explicit ``torch.Generator`` on that generator's device. Matmuls run in the
param dtype; norms, RoPE, the SiLU gate and losses compute in fp32 and cast
back, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=generator,
                    dtype=torch.float32, device=generator.device)
    w = w / math.sqrt(d_in) if scale is None else w * scale
    return w.to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    return dense_init(generator, vocab, d, dtype, scale=0.02)


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


# --------------------------------------------------------------------------
# language-model layers
def rms_norm(x, gamma, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis in fp32 with the biased variance (as
    ``jnp.var``), cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * gamma.float() + beta.float()
    return out.to(x.dtype)


def rope_freqs(positions, dim: int, theta: float):
    """cos/sin tables for given integer positions. positions [..., S]."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv  # [..., S, dim/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin [..., S, D/2] broadcast over heads."""
    d = x.shape[-1]
    xf1 = x[..., : d // 2].float()
    xf2 = x[..., d // 2:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype) -> dict:
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype),
        "w_up": dense_init(generator, d_model, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d_model, dtype),
    }


def swiglu(params, x):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def init_gelu_mlp(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype) -> dict:
    dev = generator.device
    return {
        "w_in": dense_init(generator, d_model, d_ff, dtype),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_out": dense_init(generator, d_ff, d_model, dtype),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=dev),
    }


def gelu_mlp(params, x):
    """``jax.nn.gelu``'s default is the tanh approximation, in fp32."""
    h = x @ params["w_in"] + params["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_out"] + params["b_out"]
