"""The decoder backbone: dense (GQA or MLA attention), MoE, hybrid
(attention + mamba), RWKV and VLM, driven by ``ModelConfig`` (mirrors
``repro.models.transformer``).

API (plain functions on nested dicts of tensors):
    init_params(cfg, generator, place=None)             -> params
    forward(cfg, params, tokens, img_embeds=None,
            remat=False)                                -> (features, aux)
    loss_fn(cfg, params, batch, remat=False)            -> (loss, metrics)
    init_cache(cfg, batch, cache_len, device)           -> empty cache
    prefill(cfg, params, tokens, img_embeds=None, ...)  -> (last_logits,
                                                            cache)
    decode_step(cfg, params, cache, tokens, pos)        -> (logits, cache)

Layers are stacked (a leading L axis on every leaf of ``params["layers"]``
and of the cache), as in the reference; a Python loop over L takes the
place of its ``lax.scan``; ``remat=True`` recomputes each layer in the
backward pass (``torch.utils.checkpoint``, non-reentrant), as the
reference's ``jax.checkpoint`` of its scan body does. ``aux`` is MoE's
router load-balance loss (summed over the layers; 0 for the other
families), which ``loss_fn`` adds at ``router_aux_coef``. A VLM's ``img_embeds`` [B, n_img, D] (the
stubbed vision tower's patch embeddings) go in front of the tokens, at
positions ``0 .. n_img - 1``. The encoder-decoder (audio) family is
``whisper.py``'s; this module refuses it, and any other family outside
``PORTED``, with ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import localmap
from repro_torch.device import resolve
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.tree import tree_map, tree_unstack

from . import attention, hooks, layers, moe, rwkv, ssm
from .base import ModelConfig


# (arch_type, attention, rwkv) of the families this module runs
PORTED = {("dense", "gqa", False), ("dense", "mla", False),
          ("moe", "gqa", False), ("ssm", "none", True),
          ("hybrid", "gqa", False), ("vlm", "gqa", False)}


def _check_ported(cfg: ModelConfig) -> None:
    if (cfg.arch_type, cfg.attention, cfg.rwkv) not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.arch_type} models with {cfg.attention} "
            "attention are not run by transformer.py (encoder-decoder "
            "models: whisper.py; ROADMAP.md)")


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ==========================================================================
# init
def init_layer(generator: torch.Generator, cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    dev = generator.device
    p = {"norm1": torch.ones((cfg.d_model,), dtype=cfg.dt, device=dev),
         "norm2": torch.ones((cfg.d_model,), dtype=cfg.dt, device=dev)}
    if cfg.rwkv:
        p["time_mix"] = rwkv.init_time_mix(generator, cfg)
        p["channel_mix"] = rwkv.init_channel_mix(generator, cfg)
        return p
    if cfg.attention == "mla":
        p["attn"] = attention.init_mla(generator, cfg)
    else:
        p["attn"] = attention.init_gqa(generator, cfg)
    if cfg.arch_type == "hybrid":
        p["ssm"] = ssm.init_ssm(generator, cfg)
        p["branch_norm_attn"] = torch.ones((cfg.d_model,), dtype=cfg.dt,
                                           device=dev)
        p["branch_norm_ssm"] = torch.ones((cfg.d_model,), dtype=cfg.dt,
                                          device=dev)
    if cfg.is_moe:
        p["moe"] = moe.init_moe(generator, cfg)
    else:
        p["mlp"] = layers.init_swiglu(generator, cfg.d_model, cfg.d_ff,
                                      cfg.dt)
    return p


def _placed(tree, place, path: str):
    """``place(leaf, path)`` on every leaf of a layer's nested dicts."""
    if isinstance(tree, dict):
        return {k: _placed(v, place, f"{path}/{k}") for k, v in tree.items()}
    return place(tree, path)


def _init_layers(generator: torch.Generator, cfg: ModelConfig,
                 place=None) -> dict:
    """The ``n_layers`` layers of ``init_layer``, drawn in order, each
    copied into preallocated ``[L, ...]`` leaves as it is drawn: the
    values of stacking them, with one layer above the stack in memory
    where stacking holds all the layers twice. ``place`` (as in
    :func:`init_params`) takes each layer's leaves as they are drawn; the
    stack is laid out as its placed leaves are, its layer dim whole."""
    stacked = None
    for i in range(cfg.n_layers):
        lp = init_layer(generator, cfg)
        if place is not None:
            lp = _placed(lp, place, "layers")
        if stacked is None:
            stacked = tree_map(
                lambda a: localmap.new_stack(a, cfg.n_layers), lp)
        tree_map(lambda dst, src: localmap.local(dst)[i].copy_(
            localmap.local(src)), stacked, lp)
        del lp                  # freed before the next layer is drawn
    return stacked


def init_params(cfg: ModelConfig, generator: torch.Generator,
                place=None) -> dict:
    """Parameters drawn from ``generator`` on its device, at the
    reference's scales (dense normal / sqrt(d_in), embedding and untied
    head 0.02, RWKV's constants). The values differ from the reference's
    (another generator); tests carry the reference's own parameters across
    with ``interop.lm_params_from_jax``.

    ``place(leaf, path)``, where given, takes each leaf as it is drawn
    and returns what the tree holds (``launch.steps``: the rank's shards
    of it over a mesh, so no rank holds the whole model). ``path`` is the
    leaf's path in the tree (``"embed"``, ``"layers/attn/wq"``); a layer's
    leaf comes one layer at a time, without the stack's leading dim."""
    _check_ported(cfg)
    put = place or (lambda leaf, path: leaf)
    params = {
        "embed": put(layers.embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, cfg.dt), "embed"),
        "layers": _init_layers(generator, cfg, place),
        "final_norm": put(torch.ones((cfg.d_model,), dtype=cfg.dt,
                                     device=generator.device), "final_norm"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = put(layers.dense_init(
            generator, cfg.d_model, cfg.vocab_size, cfg.dt, scale=0.02),
            "lm_head")
    return params


def lm_head_weight(cfg: ModelConfig, params):
    if "lm_head" in params:  # explicit head (incl. FACADE-untied variants)
        return params["lm_head"]
    # tied embeddings (on DTensors the head's gradient in the table's
    # layout, as the lookup's comes)
    return localmap.grad_in_layout(params["embed"]).T


# ==========================================================================
# blocks
def _ffn(cfg: ModelConfig, lp, m):
    """The layer's feed-forward: -> (out, MoE's router loss or None)."""
    if cfg.is_moe:
        return moe.moe_forward(cfg, lp["moe"], m)
    return layers.swiglu(lp["mlp"], m), None


def _fuse(cfg: ModelConfig, lp, attn_out, ssm_out):
    """Hymba's combination of its two branches, each normalised."""
    return 0.5 * (
        layers.rms_norm(attn_out, lp["branch_norm_attn"], cfg.norm_eps)
        + layers.rms_norm(ssm_out, lp["branch_norm_ssm"], cfg.norm_eps))


def block_forward(cfg: ModelConfig, lp, h, positions):
    """One layer, full sequence. Returns (h, aux): MoE's router loss, None
    for the other families. On DTensors each branch hands its gradient of
    ``h`` back in ``h``'s layout (``localmap.grad_in_layout``), so that
    the residual's and the branch's gradients add in one layout, and gets
    its output's gradient back in that output's layout, not the
    residual's (a sharded sequence under the hooks' ``seq_model``, which
    its products cannot take); the layer's FSDP shards are gathered first
    (``localmap.gather_fsdp``), and each branch's normed input is taken
    with its sequence whole (``localmap.whole_seq``)."""
    lp = localmap.gather_fsdp(lp)
    a = localmap.whole_seq(layers.rms_norm(_branch(h), lp["norm1"],
                                           cfg.norm_eps))
    if cfg.rwkv:
        tm, _, _ = rwkv.time_mix(cfg, lp["time_mix"], a)
        h = h + tm
        m = layers.rms_norm(_branch(h), lp["norm2"], cfg.norm_eps)
        cm, _ = rwkv.channel_mix(cfg, lp["channel_mix"], m)
        return h + cm, None
    if cfg.attention == "mla":
        attn_out = attention.mla_forward(cfg, lp["attn"], a, positions,
                                         window=cfg.sliding_window)
    else:
        attn_out = attention.gqa_forward(cfg, lp["attn"], a, positions,
                                         window=cfg.sliding_window)
    if cfg.arch_type == "hybrid":
        attn_out = _fuse(cfg, lp, attn_out, ssm.ssm_forward(cfg, lp["ssm"],
                                                            a))
    h = h + _branch(attn_out)
    m = localmap.whole_seq(layers.rms_norm(_branch(h), lp["norm2"],
                                           cfg.norm_eps))
    mo, aux = _ffn(cfg, lp, m)
    return h + _branch(mo), aux


def _branch(x):
    """``x`` where the residual stream and a branch meet (the residual
    entering a branch, or a branch's output joining it): under grad, its
    gradient comes back in its own layout."""
    return localmap.grad_in_layout(x) if torch.is_grad_enabled() else x


# ==========================================================================
# full-sequence forward
def embed_inputs(cfg: ModelConfig, params, tokens, img_embeds=None):
    x = localmap.lookup(params["embed"], tokens.long())
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None].expand(x.shape[:2])
    return x, positions


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, or under ``remat`` its activations dropped after the
    forward pass and recomputed in the backward one (the same values)."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def forward(cfg: ModelConfig, params, tokens, img_embeds=None,
            apply_final_norm: bool = True, remat: bool = False):
    """-> (features [B,S,D], aux); S includes a VLM's image positions.
    ``apply_final_norm=False`` returns pre-norm features (the FACADE core
    output). ``aux`` is the layers' MoE router losses summed in order (0
    without MoE). ``remat`` recomputes each layer in the backward pass."""
    _check_ported(cfg)
    h, positions = embed_inputs(cfg, params, tokens, img_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in tree_unstack(params["layers"]):      # one backward stack
        h = hooks.shard_batch(h)
        h, a = remat_call(remat, block_forward, cfg, lp, h, positions)
        if a is not None:
            aux = aux + a
    h = localmap.whole_seq(h)
    if apply_final_norm:
        h = layers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, aux


# ==========================================================================
# loss (sequence-chunked CE, so the fp32 logits of one chunk exist at a time)
def _ce_chunk(f, w_head, labels, mask):
    """Masked NLL and accuracy sums of one chunk. The product runs in the
    param dtype and is then widened, as the reference does."""
    logits = (f @ w_head).float()
    if localmap.is_dtensor(logits):
        # each rank's rows whole over the vocabulary: the log-sum-exp and
        # the gold logit's gather read them all
        logits = localmap.settle(logits, (0, 1), "logits")
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    correct = (logits.amax(dim=-1) <= gold).float()
    return ((lse - gold) * mask).sum(), (correct * mask).sum()


def chunked_ce(features, w_head, labels, mask, chunk: int = 512):
    """features [B,S,D]; labels/mask [B,S]. Mean NLL over masked tokens
    (denominator ``max(mask.sum(), 1)``), plus accuracy (the gold logit is
    a maximum). The sequence is cut into chunks as the reference cuts it
    (``S // max(1, S // chunk)`` when that divides S, else one chunk), and
    the chunks' sums are added in order; the reference also recomputes
    each chunk in the backward pass, which changes no value."""
    s = features.shape[1]
    n_chunks = max(1, s // chunk)
    chunk = s // n_chunks if s % n_chunks == 0 else s
    mask = mask.float()
    nll = torch.zeros((), dtype=torch.float32, device=features.device)
    acc = torch.zeros((), dtype=torch.float32, device=features.device)
    for c0 in range(0, s, chunk):
        dn, da = _ce_chunk(features[:, c0:c0 + chunk], w_head,
                           labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk])
        nll = nll + dn
        acc = acc + da
    denom = torch.clamp(mask.sum(), min=1.0)
    return nll / denom, acc / denom


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = False):
    """batch: {tokens [B,S], labels [B,S], mask [B,S], img_embeds?} ->
    (loss, metrics). The loss is the masked mean NLL over the text
    positions plus ``router_aux_coef`` times MoE's router loss ``aux`` (0
    without MoE); the metrics hold ``ce`` (the NLL), ``aux`` and ``acc``.
    ``remat``: as :func:`forward`'s."""
    img = batch.get("img_embeds")
    feats, aux = forward(cfg, params, batch["tokens"], img_embeds=img,
                         remat=remat)
    feats = feats[:, 0 if img is None else img.shape[1]:]
    loss, acc = chunked_ce(feats,
                           localmap.gather_fsdp(lm_head_weight(cfg, params)),
                           batch["labels"], batch["mask"])
    total = loss + cfg.router_aux_coef * aux
    return total, {"ce": loss, "aux": aux, "acc": acc}


# ==========================================================================
# caches
def _layer_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    _check_ported(cfg)
    if cfg.rwkv:
        return rwkv.rwkv_init_cache(cfg, batch, device)
    if cfg.attention == "mla":
        c = attention.mla_init_cache(cfg, batch, cache_len, device)
    else:
        c = attention.gqa_init_cache(cfg, batch, cache_len, device)
    if cfg.arch_type == "hybrid":
        c = {"attn": c, "ssm": ssm.ssm_init_cache(cfg, batch, device)}
    return c


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda"):
    """An empty decode cache with a leading L axis (prefill builds its own
    filled cache)."""
    one = _layer_cache(cfg, batch, cache_len, resolve(device))
    return tree_map(
        lambda a: a[None].expand((cfg.n_layers,) + a.shape).clone(), one)


def extend_cache(cfg: ModelConfig, caches, extra: int):
    """Append ``extra`` empty slots to a prefilled cache so subsequent
    decode steps have somewhere to write. No-op for ring-buffer (sliding
    window) caches, where wraparound eviction is the semantics, and for
    state-only (rwkv) caches."""
    if extra <= 0 or cfg.rwkv:
        return caches

    def pad(leaf, fill):
        shape = list(leaf.shape)
        shape[2] = extra                          # [L, B, slots, ...]
        return torch.cat([leaf, torch.full(shape, fill, dtype=leaf.dtype,
                                           device=leaf.device)], dim=2)

    def pad_attn(c):
        if cfg.sliding_window and \
                c["slot_pos"].shape[-1] == cfg.sliding_window:
            return c  # ring buffer: leave alone
        return {name: pad(leaf, -1 if name == "slot_pos" else 0)
                for name, leaf in c.items()}

    if cfg.arch_type == "hybrid":
        return {"attn": pad_attn(caches["attn"]), "ssm": caches["ssm"]}
    return pad_attn(caches)


def cache_physical_len(cfg: ModelConfig, seq_len: int) -> int:
    """Sliding-window archs store the ring-buffer window as the physical
    cache; others store seq_len slots."""
    if cfg.rwkv:
        return 1  # state-only; attn cache unused
    if cfg.sliding_window and seq_len > cfg.sliding_window:
        return cfg.sliding_window
    return seq_len


# ==========================================================================
# decode
def block_decode(cfg: ModelConfig, lp, h, pos, cache):
    lp = localmap.gather_fsdp(lp)
    a = layers.rms_norm(h, lp["norm1"], cfg.norm_eps)
    if cfg.rwkv:
        tm, s_new, tmx = rwkv.time_mix(cfg, lp["time_mix"], a,
                                       state=cache["s"], last_x=cache["tm_x"])
        h = h + tm
        m = layers.rms_norm(h, lp["norm2"], cfg.norm_eps)
        cm, cmx = rwkv.channel_mix(cfg, lp["channel_mix"], m,
                                   last_x=cache["cm_x"])
        return h + cm, {"s": s_new, "tm_x": tmx, "cm_x": cmx}
    decode = (attention.mla_decode if cfg.attention == "mla"
              else attention.gqa_decode)
    hybrid = cfg.arch_type == "hybrid"
    attn_out, new_cache = decode(cfg, lp["attn"], a, pos,
                                 cache["attn"] if hybrid else cache,
                                 window=cfg.sliding_window)
    if hybrid:
        ssm_out, new_ssm = ssm.ssm_decode(cfg, lp["ssm"], a, cache["ssm"])
        attn_out = _fuse(cfg, lp, attn_out, ssm_out)
        new_cache = {"attn": new_cache, "ssm": new_ssm}
    h = h + attn_out
    m = layers.rms_norm(h, lp["norm2"], cfg.norm_eps)
    return h + _ffn(cfg, lp, m)[0], new_cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    """tokens [B,1] int; pos [B] int -> (logits [B,V] fp32, new cache)."""
    _check_ported(cfg)
    h = localmap.lookup(params["embed"], tokens.long())
    new = []
    for i in range(cfg.n_layers):
        h, nc = block_decode(cfg, _layer(params["layers"], i), h, pos,
                             _layer(cache, i))
        new.append(nc)
    feats = layers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (feats[:, 0] @ lm_head_weight(cfg, params)).float()
    return logits, _stack(new)


# ==========================================================================
# prefill: full forward that also materializes the decode cache
def prefill(cfg: ModelConfig, params, tokens, img_embeds=None,
            cache_extra: int = 0):
    """-> (last-position logits [B,V] fp32, cache ready for decode at
    pos=S, S counting a VLM's ``n_img`` image positions in front of the
    tokens). ``cache_extra`` reserves empty slots for tokens generated
    afterwards. Attention (MLA's through ``attention.mla_attention``) and
    the wkv recurrence run through the hand-written kernels on the card
    (one launch per layer); hymba's mamba branch is the plain scan, whose
    final state and conv window it caches."""
    _check_ported(cfg)
    h, positions = embed_inputs(cfg, params, tokens, img_embeds)
    b, s = h.shape[:2]
    cache_len = cache_physical_len(cfg, s)
    caches = []
    for i in range(cfg.n_layers):
        lp = localmap.gather_fsdp(_layer(params["layers"], i))
        h = hooks.shard_batch(h)
        a = layers.rms_norm(h, lp["norm1"], cfg.norm_eps)
        if cfg.rwkv:
            tm, s_new, tmx = rwkv.time_mix(cfg, lp["time_mix"], a)
            h = h + tm
            m = layers.rms_norm(h, lp["norm2"], cfg.norm_eps)
            cm, cmx = rwkv.channel_mix(cfg, lp["channel_mix"], m)
            h = h + cm
            caches.append({"s": s_new, "tm_x": tmx, "cm_x": cmx})
            continue

        if cfg.attention == "mla":
            c_kv, k_rope = attention._mla_ckv(cfg, lp["attn"], a, positions)
            attn_out = attention.mla_forward(cfg, lp["attn"], a, positions,
                                             window=cfg.sliding_window,
                                             ckv=(c_kv, k_rope))
            kv = {"c_kv": c_kv, "k_rope": k_rope}
        else:
            q, k, v = attention._gqa_qkv(cfg, lp["attn"], a, positions)
            attn_out = flash_attention(q, k, v, causal=True,
                                       window=cfg.sliding_window)
            attn_out = localmap.merge_last(attn_out).to(h.dtype) \
                @ lp["attn"]["wo"]
            kv = {"k": k, "v": v}

        # ring-buffer placement: slot j holds position start + ((j-start)%W)
        start = s - cache_len
        slots = torch.arange(cache_len, device=h.device)
        src = start + (slots - start) % cache_len
        cache_l = {name: leaf[:, src] for name, leaf in kv.items()}
        cache_l["slot_pos"] = src.to(torch.int32)[None].expand(b, cache_len)
        if cfg.arch_type == "hybrid":
            ssm_out, h_ssm, u = ssm.ssm_branch(cfg, lp["ssm"], a)
            attn_out = _fuse(cfg, lp, attn_out, ssm_out)
            cache_l = {"attn": cache_l,
                       "ssm": {"h": h_ssm, "conv": ssm.conv_tail(cfg, u)}}
        h = h + attn_out
        caches.append(cache_l)

        m = layers.rms_norm(h, lp["norm2"], cfg.norm_eps)
        h = h + _ffn(cfg, lp, m)[0]

    cache = extend_cache(cfg, _stack(caches), cache_extra)
    feats = layers.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (feats[:, -1] @ lm_head_weight(cfg, params)).float()
    return logits, cache
