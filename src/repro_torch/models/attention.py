"""Grouped-query attention (opt. qk-norm, sliding window) and its KV cache
(mirrors the GQA part of ``repro.models.attention``).

Two execution paths:
  * ``gqa_forward`` — train / prefill over a full sequence (causal), at
    positions ``arange(S)``. Where a gradient is needed (grad mode on and
    q, k or v requiring grad), on any device, the plain differentiable
    ``sdpa`` below (the reference's ``sdpa_auto`` takes it below its
    chunking threshold of 4096² scores, which every ported training shape
    is); otherwise the ``kernels/flash_attention`` wrapper, which launches
    the hand-written kernel on the card (it has no backward) and runs its
    plain version on the CPU.
  * ``gqa_decode`` — one new token against a KV cache (full or ring
    buffer), through the plain ``sdpa`` on every device, as in the
    reference.

Masking is position-based everywhere: a kv slot participates iff
``kv_pos >= 0  and  kv_pos <= q_pos  and (window == 0 or q_pos - kv_pos < window)``.
MLA is not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention

from . import layers
from .base import ModelConfig

NEG_INF = -1e30


# ==========================================================================
# scaled dot-product attention with position masking
def sdpa(q, k, v, q_pos, kv_pos, window: int = 0, scale: float | None = None):
    """q [B,Sq,Hq,Dq]  k [B,Skv,Hkv,Dq]  v [B,Skv,Hkv,Dv]
    q_pos [B,Sq] int, kv_pos [B,Skv] int (-1 = invalid slot).
    Returns [B,Sq,Hq,Dv]. Scores and softmax in fp32; query head h reads
    kv head ``h // (Hq/Hkv)``."""
    hq, dq = q.shape[2], q.shape[3]
    g = hq // k.shape[2]
    scale = scale if scale is not None else 1.0 / dq ** 0.5
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)

    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :]
                                         <= q_pos[:, :, None])
    if window > 0:
        valid &= (q_pos[:, :, None] - kv_pos[:, None, :]) < window
    scores = torch.where(valid[:, None, :, :], scores, NEG_INF)

    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


# ==========================================================================
# GQA
def init_gqa(generator: torch.Generator, cfg: ModelConfig) -> dict:
    hd = cfg.hd
    p = {
        "wq": layers.dense_init(generator, cfg.d_model, cfg.n_heads * hd,
                                cfg.dt),
        "wk": layers.dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd,
                                cfg.dt),
        "wv": layers.dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd,
                                cfg.dt),
        "wo": layers.dense_init(generator, cfg.n_heads * hd, cfg.d_model,
                                cfg.dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=cfg.dt,
                                 device=generator.device)
        p["k_norm"] = torch.ones((hd,), dtype=cfg.dt,
                                 device=generator.device)
    return p


def _gqa_qkv(cfg: ModelConfig, p, x, positions):
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = layers.rope_freqs(positions, hd, cfg.rope_theta)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def gqa_forward(cfg: ModelConfig, p, x, positions, window: int = 0):
    """Causal self-attention over a full sequence. positions [B,S], each
    row ``arange(S)`` (what ``embed_inputs`` gives). Training goes through
    the differentiable ``sdpa``, everything else through the kernel."""
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = sdpa(q, k, v, positions, positions, window=window)
    else:
        out = flash_attention(q, k, v, causal=True, window=window)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1).to(x.dtype) @ p["wo"]


def gqa_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   device) -> dict:
    hd = cfg.hd
    return {
        "k": torch.zeros((batch, cache_len, cfg.n_kv_heads, hd),
                         dtype=cfg.dt, device=device),
        "v": torch.zeros((batch, cache_len, cfg.n_kv_heads, hd),
                         dtype=cfg.dt, device=device),
        "slot_pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                               device=device),
    }


def gqa_decode(cfg: ModelConfig, p, x, pos, cache, window: int = 0):
    """One-token decode. x [B,1,D]; pos [B] int absolute position.

    Works for both a full-length cache (cache_len >= pos) and a ring buffer
    (cache_len == window): the write slot is ``pos % cache_len``. Returns a
    new cache; the one passed in is not changed.
    """
    b = x.shape[0]
    q, k, v = _gqa_qkv(cfg, p, x, pos[:, None])
    cache_len = cache["k"].shape[1]
    slot = pos.long() % cache_len
    hit = torch.arange(cache_len, device=x.device)[None, :] == slot[:, None]
    ck = torch.where(hit[:, :, None, None], k, cache["k"])
    cv = torch.where(hit[:, :, None, None], v, cache["v"])
    sp = torch.where(hit, pos[:, None].to(torch.int32), cache["slot_pos"])

    out = sdpa(q, ck, cv, pos[:, None], sp, window=window)
    y = out.reshape(b, 1, -1).to(x.dtype) @ p["wo"]
    return y, {"k": ck, "v": cv, "slot_pos": sp}
