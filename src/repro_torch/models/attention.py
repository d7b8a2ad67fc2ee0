"""Grouped-query attention (opt. qk-norm, sliding window), multi-head
latent attention (MLA) and their KV caches (mirrors
``repro.models.attention``).

Two execution paths per variant:
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
  * ``mla_forward`` follows ``gqa_forward``'s rule; its kernel call
    (``mla_attention``) zero-pads q, k (``qk_nope + qk_rope``) and v
    (``v_head_dim``) to one head dim the kernel takes and slices the
    output back. ``mla_decode`` is the reference's absorbed form (the
    cache holds the compressed ``c_kv`` and the shared ``k_rope``), in
    plain PyTorch on every device.

Masking is position-based everywhere: a kv slot participates iff
``kv_pos >= 0  and  kv_pos <= q_pos  and (window == 0 or q_pos - kv_pos < window)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
from repro_torch import localmap
from repro_torch.localmap import merge_last, split_last

from . import hooks, layers
from .base import ModelConfig

NEG_INF = -1e30


# ==========================================================================
# scaled dot-product attention with position masking
def sdpa(q, k, v, q_pos, kv_pos, window: int = 0, scale: float | None = None):
    """q [B,Sq,Hq,Dq]  k [B,Skv,Hkv,Dq]  v [B,Skv,Hkv,Dv]
    q_pos [B,Sq] int, kv_pos [B,Skv] int (-1 = invalid slot).
    Returns [B,Sq,Hq,Dv]. Scores and softmax in fp32; query head h reads
    kv head ``h // (Hq/Hkv)``. On DTensors each rank attends with its
    batch rows and query heads (q also its rows of Sq, with their
    positions) to the whole of k and v (``localmap.heads_on_shards``)."""
    if localmap.any_dtensor(q, k, v):
        return localmap.heads_on_shards(
            lambda *a: sdpa(*a, window=window, scale=scale), q, k, v,
            (q_pos,), (kv_pos,), name="sdpa", q_seq=True)
    hq, dq = q.shape[2], q.shape[3]
    g = hq // k.shape[2]
    scale = scale if scale is not None else 1.0 / dq ** 0.5
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)

    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = hooks.shard_heads(scores, batch_dim=0, head_dim=1, seq_dim=2)
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
    q = split_last(x @ p["wq"], cfg.n_heads, hd)
    k = split_last(x @ p["wk"], cfg.n_kv_heads, hd)
    v = split_last(x @ p["wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = layers.rope_freqs(positions, hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    # q may fall back to sequence sharding; k and v must not (their
    # sequence is the softmax's): they stay replicated where heads do not
    # divide
    return (hooks.shard_heads(q, seq_dim=1), hooks.shard_heads(k),
            hooks.shard_heads(v))


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def gqa_forward(cfg: ModelConfig, p, x, positions, window: int = 0):
    """Causal self-attention over a full sequence. positions [B,S], each
    row ``arange(S)`` (what ``embed_inputs`` gives). Training goes through
    the differentiable ``sdpa``, everything else through the kernel."""
    q, k, v = _gqa_qkv(cfg, p, x, positions)
    if _needs_grad(q, k, v):
        out = sdpa(q, k, v, positions, positions, window=window)
    else:
        out = flash_attention(q, k, v, causal=True, window=window)
    out = hooks.shard_batch(out)
    return localmap.whole_seq(merge_last(out)).to(x.dtype) @ p["wo"]


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
    y = merge_last(out).to(x.dtype) @ p["wo"]
    return y, {"k": ck, "v": cv, "slot_pos": sp}


# ==========================================================================
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 family)
def init_mla(generator: torch.Generator, cfg: ModelConfig) -> dict:
    h = cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    dev = generator.device
    return {
        "w_dq": layers.dense_init(generator, cfg.d_model, cfg.q_lora_rank,
                                  cfg.dt),
        "q_norm": torch.ones((cfg.q_lora_rank,), dtype=cfg.dt, device=dev),
        "w_uq": layers.dense_init(generator, cfg.q_lora_rank, h * qd,
                                  cfg.dt),
        # joint compression: [kv_rank | rope_dim]
        "w_dkv": layers.dense_init(generator, cfg.d_model,
                                   cfg.kv_lora_rank + cfg.qk_rope_dim,
                                   cfg.dt),
        "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=cfg.dt,
                              device=dev),
        "w_uk": layers.dense_init(generator, cfg.kv_lora_rank,
                                  h * cfg.qk_nope_dim, cfg.dt),
        "w_uv": layers.dense_init(generator, cfg.kv_lora_rank,
                                  h * cfg.v_head_dim, cfg.dt),
        "wo": layers.dense_init(generator, h * cfg.v_head_dim, cfg.d_model,
                                cfg.dt),
    }


def _mla_q(cfg: ModelConfig, p, x, positions):
    b, s, _ = x.shape
    cq = layers.rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = split_last(cq @ p["w_uq"], cfg.n_heads,
                   cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    cos, sin = layers.rope_freqs(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return q_nope, layers.apply_rope(q_rope, cos, sin)


def _mla_ckv(cfg: ModelConfig, p, x, positions):
    """-> (c_kv [B,S,kv_rank] normed, k_rope [B,S,rope_dim] rotated): what
    the decode cache holds."""
    c_kv, k_rope = (x @ p["w_dkv"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    c_kv = layers.rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    cos, sin = layers.rope_freqs(positions, cfg.qk_rope_dim, cfg.rope_theta)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def mla_attention(q, k, v, window: int = 0):
    """Causal attention of q, k [B,S,H,Dqk] and v [B,S,H,Dv] (Dqk != Dv)
    through the kernel, which takes one head dim: all three zero-padded to
    the smallest of ``HEAD_DIMS`` that holds both (the padded columns add
    exact zeros to the scores, and the padded output columns are sliced
    off), scaled by ``1/sqrt(Dqk)``. -> [B,S,H,Dv]."""
    dq, dv = q.shape[-1], v.shape[-1]
    d = min(x for x in HEAD_DIMS if x >= max(dq, dv))
    q, k, v = (F.pad(t, (0, d - t.shape[-1])) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=True, window=window,
                          scale=1.0 / dq ** 0.5)
    return out[..., :dv]


def mla_forward(cfg: ModelConfig, p, x, positions, window: int = 0,
                ckv=None):
    """Train/prefill MLA: decompress k and v, then attention as
    ``gqa_forward`` takes it (the differentiable ``sdpa`` under a
    gradient, else the kernel through ``mla_attention``). ``ckv``: the
    ``_mla_ckv`` of ``x`` where the caller has it already (prefill)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = ckv if ckv is not None else _mla_ckv(cfg, p, x,
                                                        positions)
    k_nope = split_last(c_kv @ p["w_uk"], h, cfg.qk_nope_dim)
    v = split_last(c_kv @ p["w_uv"], h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1)
    q = hooks.shard_heads(q, seq_dim=1)
    k, v = hooks.shard_heads(k), hooks.shard_heads(v)
    if _needs_grad(q, k, v):
        out = sdpa(q, k, v, positions, positions, window=window)
    else:
        out = mla_attention(q, k, v, window=window)
    out = hooks.shard_batch(out)
    return localmap.whole_seq(merge_last(out)).to(x.dtype) @ p["wo"]


def mla_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   device) -> dict:
    return {
        "c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                            dtype=cfg.dt, device=device),
        "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                              dtype=cfg.dt, device=device),
        "slot_pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                               device=device),
    }


def mla_decode(cfg: ModelConfig, p, x, pos, cache, window: int = 0):
    """Absorbed one-token MLA decode: attention runs in the compressed
    space, ``score_h = q_nope_h Wuk_h^T c_kv^T + q_rope . k_rope`` and
    ``out_h = (alpha_h c_kv) Wuv_h``; the cache never holds per-head k or
    v. Scores in fp32, as ``sdpa``. Returns a new cache."""
    b = x.shape[0]
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])      # [B,1,H,*]
    c_new, r_new = _mla_ckv(cfg, p, x, pos[:, None])      # [B,1,rank|rd]

    cache_len = cache["c_kv"].shape[1]
    slot = pos.long() % cache_len
    hit = torch.arange(cache_len, device=x.device)[None, :] == slot[:, None]
    c_kv = torch.where(hit[:, :, None], c_new, cache["c_kv"])
    k_rope = torch.where(hit[:, :, None], r_new, cache["k_rope"])
    sp = torch.where(hit, pos[:, None].to(torch.int32), cache["slot_pos"])

    wuk = split_last(p["w_uk"], h, cfg.qk_nope_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wuk)   # absorbed
    scores = torch.einsum("bhr,bsr->bhs", q_abs.float(), c_kv.float())
    scores = scores + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                                   k_rope.float())
    scores = scores / (cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5

    valid = (sp >= 0) & (sp <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - sp) < window
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    alpha = torch.softmax(scores, dim=-1).to(cfg.dt)

    out_c = torch.einsum("bhs,bsr->bhr", alpha, c_kv)
    wuv = split_last(p["w_uv"], h, cfg.v_head_dim)
    out = merge_last(torch.einsum("bhr,rhd->bhd", out_c, wuv))[:, None]
    y = out.to(x.dtype) @ p["wo"]
    return y, {"c_kv": c_kv, "k_rope": k_rope, "slot_pos": sp}
