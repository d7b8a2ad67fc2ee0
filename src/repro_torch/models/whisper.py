"""Whisper-style encoder-decoder transformer backbone [arXiv:2212.04356]
(mirrors ``repro.models.whisper``).

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the encoder takes precomputed frame embeddings ``[B, S_enc,
d_model]``. This module is the transformer itself: a bidirectional
encoder, a causal decoder with cross-attention, a tied head, and a decode
step over self- and cross-attention caches.

Where attention runs: self-attention (the encoder's, bidirectional, and
the decoder's in ``forward``, causal) goes through the
``kernels/flash_attention`` wrapper when no gradient is needed (the
kernel on the card, its plain version on the CPU), else the plain
differentiable ``attention.sdpa``, as ``attention.gqa_forward`` decides.
Cross-attention (query and key lengths differ, and the kernel takes one
S) and the decode step's attention are the plain ``sdpa``, as in the
reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.localmap import merge_last, split_last
from repro_torch.tree import tree_map, tree_unstack

from . import attention, layers
from .base import ModelConfig
from .transformer import chunked_ce, remat_call


def sinusoids(length: int, channels: int, device=None):
    """[length, channels] fp32: sin then cos, timescales spaced by
    ``log(10000) / (channels // 2 - 1)``."""
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-torch.arange(channels // 2, dtype=torch.float32,
                                  device=device)
                    * (math.log(10000.0) / (channels // 2 - 1)))
    ang = t * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_mha(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {name: layers.dense_init(generator, d, d, cfg.dt)
            for name in ("wq", "wk", "wv", "wo")}


def _mha(cfg: ModelConfig, p, xq, xkv=None, *, causal: bool):
    """Multi-head attention of ``xq`` over ``xkv`` (self-attention when
    ``xkv`` is None), positions ``arange``; ``causal=False`` makes every
    key visible. Self-attention without a gradient goes to the kernel."""
    self_attn = xkv is None
    xkv = xq if self_attn else xkv
    b, sq, d = xq.shape
    skv = xkv.shape[1]
    h = cfg.n_heads
    hd = d // h
    q = split_last(xq @ p["wq"], h, hd)
    k = split_last(xkv @ p["wk"], h, hd)
    v = split_last(xkv @ p["wv"], h, hd)
    if self_attn and not attention._needs_grad(q, k, v):
        out = flash_attention(q, k, v, causal=causal)
    else:
        q_pos = torch.arange(sq, dtype=torch.int32,
                             device=xq.device)[None].expand(b, sq)
        kv_pos = torch.arange(skv, dtype=torch.int32,
                              device=xq.device)[None].expand(b, skv)
        if not causal:  # bidirectional: every kv slot visible
            kv_pos = torch.zeros_like(kv_pos)
            q_pos = torch.ones_like(q_pos)
        out = attention.sdpa(q, k, v, q_pos, kv_pos)
    return merge_last(out).to(xq.dtype) @ p["wo"]


def _ln(cfg: ModelConfig, x, p):
    return layers.layer_norm(x, p["g"], p["b"], cfg.norm_eps)


def _init_ln(cfg: ModelConfig, device) -> dict:
    return {"g": torch.ones((cfg.d_model,), dtype=cfg.dt, device=device),
            "b": torch.zeros((cfg.d_model,), dtype=cfg.dt, device=device)}


def init_enc_layer(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dev = generator.device
    return {"ln1": _init_ln(cfg, dev), "attn": _init_mha(generator, cfg),
            "ln2": _init_ln(cfg, dev),
            "mlp": layers.init_gelu_mlp(generator, cfg.d_model, cfg.d_ff,
                                        cfg.dt)}


def init_dec_layer(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dev = generator.device
    return {"ln1": _init_ln(cfg, dev),
            "self_attn": _init_mha(generator, cfg),
            "ln2": _init_ln(cfg, dev),
            "cross_attn": _init_mha(generator, cfg),
            "ln3": _init_ln(cfg, dev),
            "mlp": layers.init_gelu_mlp(generator, cfg.d_model, cfg.d_ff,
                                        cfg.dt)}


def _stacked(init, generator, cfg, n: int) -> dict:
    layers_ = [init(generator, cfg) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *layers_)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Parameters drawn from ``generator`` on its device at the
    reference's scales (the values differ from the reference's; tests
    carry its own across with ``interop.lm_params_from_jax``)."""
    dev = generator.device
    enc = _stacked(init_enc_layer, generator, cfg, cfg.encoder_layers)
    dec = _stacked(init_dec_layer, generator, cfg, cfg.n_layers)
    pos_embed = (torch.randn((cfg.max_decoder_len, cfg.d_model),
                             generator=generator, dtype=torch.float32,
                             device=dev) * 0.01).to(cfg.dt)
    return {
        "encoder": {"layers": enc, "ln_post": _init_ln(cfg, dev)},
        "decoder": {"pos_embed": pos_embed, "layers": dec},
        "embed": layers.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                   cfg.dt),
        "final_norm": _init_ln(cfg, dev),
    }


# ==========================================================================
def encode(cfg: ModelConfig, params, frames):
    """frames [B, S_enc, D] (stubbed conv features) -> [B, S_enc, D]."""
    s, d = frames.shape[1:]
    h = frames.to(cfg.dt) + sinusoids(s, d, frames.device).to(cfg.dt)[None]
    for lp in tree_unstack(params["encoder"]["layers"]):
        a = _ln(cfg, h, lp["ln1"])
        h = h + _mha(cfg, lp["attn"], a, causal=False)
        m = _ln(cfg, h, lp["ln2"])
        h = h + layers.gelu_mlp(lp["mlp"], m)
    return _ln(cfg, h, params["encoder"]["ln_post"])


def lm_head_weight(params):
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def _dec_block(cfg: ModelConfig, lp, h, enc):
    a = _ln(cfg, h, lp["ln1"])
    h = h + _mha(cfg, lp["self_attn"], a, causal=True)
    c = _ln(cfg, h, lp["ln2"])
    h = h + _mha(cfg, lp["cross_attn"], c, enc, causal=False)
    m = _ln(cfg, h, lp["ln3"])
    return h + layers.gelu_mlp(lp["mlp"], m)


def forward(cfg: ModelConfig, params, tokens, frames,
            apply_final_norm: bool = True, remat: bool = False):
    """Teacher-forced decode over the whole target -> (features [B,S,D],
    aux = 0). ``remat`` recomputes each decoder layer in the backward
    pass (the encoder's are kept, as in the reference)."""
    enc = encode(cfg, params, frames)
    s = tokens.shape[1]
    h = params["embed"][tokens.long()] + params["decoder"]["pos_embed"][
        None, :s]
    for lp in tree_unstack(params["decoder"]["layers"]):
        h = remat_call(remat, _dec_block, cfg, lp, h, enc)
    if apply_final_norm:
        h = _ln(cfg, h, params["final_norm"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = False):
    """batch: {tokens, labels, mask [B,S], frames [B,S_enc,D]} -> (loss,
    metrics ``ce``, ``aux`` (0), ``acc``)."""
    feats, aux = forward(cfg, params, batch["tokens"], batch["frames"],
                         remat=remat)
    loss, acc = chunked_ce(feats, lm_head_weight(params), batch["labels"],
                           batch["mask"])
    return loss, {"ce": loss, "aux": aux, "acc": acc}


# ==========================================================================
# serving: cross k/v computed once; decoder self-attention cache per layer
def init_cache(cfg: ModelConfig, params, frames, batch: int,
               cache_len: int) -> dict:
    """Encode ``frames`` and return ``{"self": empty self-attention cache
    [L, B, cache_len, H, hd] (slot_pos -1), "cross": each layer's k, v of
    the encoder output}``."""
    enc = encode(cfg, params, frames)
    d, h = cfg.d_model, cfg.n_heads
    dev = enc.device
    cross = [{"k": (enc @ lp["cross_attn"]["wk"]).reshape(
                  batch, enc.shape[1], h, d // h),
              "v": (enc @ lp["cross_attn"]["wv"]).reshape(
                  batch, enc.shape[1], h, d // h)}
             for lp in tree_unstack(params["decoder"]["layers"])]
    shape = (cfg.n_layers, batch, cache_len, h, d // h)
    self_c = {"k": torch.zeros(shape, dtype=cfg.dt, device=dev),
              "v": torch.zeros(shape, dtype=cfg.dt, device=dev),
              "slot_pos": torch.full((cfg.n_layers, batch, cache_len), -1,
                                     dtype=torch.int32, device=dev)}
    return {"self": self_c,
            "cross": tree_map(lambda *xs: torch.stack(xs), *cross)}


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """tokens [B,1], pos [B] -> (logits [B,V] fp32, new cache). The
    position embedding is clamped at ``max_decoder_len - 1``; the new k
    and v go to slot ``pos % cache_len``."""
    b = tokens.shape[0]
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    pe = params["decoder"]["pos_embed"][
        torch.clamp(pos.long(), max=cfg.max_decoder_len - 1)]
    h = params["embed"][tokens.long()] + pe[:, None, :]
    new_self = []
    for lp, sc, cc in zip(tree_unstack(params["decoder"]["layers"]),
                          tree_unstack(cache["self"]),
                          tree_unstack(cache["cross"])):
        a = _ln(cfg, h, lp["ln1"])
        q = split_last(a @ lp["self_attn"]["wq"], nh, hd)
        k = split_last(a @ lp["self_attn"]["wk"], nh, hd)
        v = split_last(a @ lp["self_attn"]["wv"], nh, hd)
        cache_len = sc["k"].shape[1]
        slot = pos.long() % cache_len
        hit = torch.arange(cache_len, device=h.device)[None, :] == \
            slot[:, None]
        ck = torch.where(hit[:, :, None, None], k, sc["k"])
        cv = torch.where(hit[:, :, None, None], v, sc["v"])
        sp = torch.where(hit, pos[:, None].to(torch.int32), sc["slot_pos"])
        out = attention.sdpa(q, ck, cv, pos[:, None], sp)
        h = h + merge_last(out).to(h.dtype) @ lp["self_attn"]["wo"]

        c = _ln(cfg, h, lp["ln2"])
        qc = split_last(c @ lp["cross_attn"]["wq"], nh, hd)
        s_enc = cc["k"].shape[1]
        out = attention.sdpa(
            qc, cc["k"], cc["v"],
            torch.ones((b, 1), dtype=torch.int32, device=h.device),
            torch.zeros((b, s_enc), dtype=torch.int32, device=h.device))
        h = h + merge_last(out).to(h.dtype) @ lp["cross_attn"]["wo"]

        m = _ln(cfg, h, lp["ln3"])
        h = h + layers.gelu_mlp(lp["mlp"], m)
        new_self.append({"k": ck, "v": cv, "slot_pos": sp})
    feats = _ln(cfg, h, params["final_norm"])
    logits = (feats[:, 0] @ lm_head_weight(params)).float()
    return logits, {"self": tree_map(lambda *xs: torch.stack(xs),
                                     *new_self),
                    "cross": cache["cross"]}
