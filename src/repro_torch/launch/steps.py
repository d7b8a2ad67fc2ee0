"""Step builders and their inputs for every (arch × input-shape) pair (the
counterpart of ``repro.launch.steps``).

Three step kinds, as the reference's:
  * train_4k      -> train_step(params, opt_state, batch)
  * prefill_32k   -> prefill_step(params, batch)      (logits + filled cache)
  * decode_32k /
    long_500k     -> serve_step(params, cache, tokens, pos)  (1 new token)

plus the FACADE step of the paper's technique:
  * facade_step(state, batches, drawn) — 2 nodes, each a whole model,
    gossiping cluster heads (one card holds both).

:func:`build_case` returns the step and its arguments: real tensors on
``device`` (default the card), drawn from ``seed``, or with
``abstract=True`` the fake tensors of a ``FakeTensorMode`` (shapes and
dtypes, nothing allocated) at the input shape's full size, which the dry
run (``launch/dryrun.py``) traces on the CPU inside ``case.context``. A
decode case's cache is filled as a prefill of the context would leave it
(random keys and values, each slot holding the latest position before
``pos`` that maps to it), and ``pos`` is the context's last position.

Left out of the reference's signatures: the mesh and how the step is
sharded over it (``mesh``, ``fsdp``, ``act_sharding``, ``seq_model``: the
port runs one card; the mesh slice brings them) and ``unroll`` (the
port's layers are a Python loop, so there is no scan to unroll and every
layer is counted). Added: ``batch`` and ``cfg``, through which a caller
runs a step cut in batch or depth (the default is the input shape's batch
and :func:`resolve_config`'s model), and ``remat`` on the FACADE case.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import optim
from repro_torch.configs import (INPUT_SHAPES, LONG_CTX_SKIP,
                                 LONG_CTX_SWA_ARCHS, LONG_CTX_SWA_WINDOW)
from repro_torch.core import facade as facade_mod
from repro_torch.core import topology
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import init_facade_state
from repro_torch.device import resolve
from repro_torch.models import api, transformer, whisper
from repro_torch.models.base import ModelConfig, get_config
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the image embeddings' scale (the stubbed vision tower, as the token
# embeddings'); frames, keys, values and states are unit normal
IMG_STD = 0.02


# --------------------------------------------------------------------------
def resolve_config(arch_id: str, shape_name: str) -> ModelConfig:
    cfg = get_config(arch_id)
    if shape_name == "long_500k" and arch_id in LONG_CTX_SWA_ARCHS:
        cfg = cfg.replace(sliding_window=LONG_CTX_SWA_WINDOW)
    return cfg


def is_supported(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k" and arch_id in LONG_CTX_SKIP:
        return False
    return True


def make_optimizer(arch_id: str, cfg: ModelConfig):
    """grok-1: momentum with bf16 slots (the reference's choice for its
    314B parameters); everything else AdamW with fp32 slots."""
    if arch_id == "grok-1-314b":
        return optim.momentum(1e-4, slot_dtype=torch.bfloat16)
    return optim.adamw(3e-4)


# --------------------------------------------------------------------------
def _lm_batch(cfg: ModelConfig, b: int, s: int, gen: torch.Generator,
              lead: tuple = ()):
    """The batch layout of the reference's ``_lm_batch_sds`` (with
    ``lead`` axes in front): a VLM's image positions come out of the
    sequence budget, whisper's decoder takes ``min(S, max_decoder_len)``
    tokens and its frames. Tokens and labels uniform over the vocabulary,
    the mask all ones."""
    dev = gen.device
    n_txt = s
    extra = {}
    if cfg.arch_type == "vlm":
        n_txt = s - cfg.n_image_tokens
        extra["img_embeds"] = (IMG_STD * torch.randn(
            lead + (b, cfg.n_image_tokens, cfg.d_model), generator=gen,
            device=dev)).to(cfg.dt)
    if cfg.encoder_layers > 0:
        n_txt = min(s, cfg.max_decoder_len)
        extra["frames"] = torch.randn(
            lead + (b, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev).to(cfg.dt)
    shape = lead + (b, n_txt)
    return {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                    device=dev, dtype=torch.int32),
            "labels": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                    device=dev, dtype=torch.int32),
            "mask": torch.ones(shape, dtype=torch.float32, device=dev),
            **extra}


def slot_positions(cache_len: int, pos: int, device) -> torch.Tensor:
    """``[cache_len]`` int32: the position slot j holds before a decode
    at ``pos`` (the latest p < pos with p % cache_len == j; -1 where there
    is none), as prefilling positions ``0 .. pos - 1`` leaves a cache or
    a ring buffer."""
    j = torch.arange(cache_len, device=device, dtype=torch.int64)
    p = j + cache_len * torch.div(pos - 1 - j, cache_len,
                                  rounding_mode="floor")
    return torch.where(p >= 0, p, torch.full_like(p, -1)).to(torch.int32)


def _fill_cache(cache, pos: int, gen: torch.Generator):
    """Fill an empty cache tree in place (no second copy of it exists at
    any time) and return it: float leaves unit normal, every ``slot_pos``
    leaf :func:`slot_positions`."""
    for key, leaf in cache.items():
        if isinstance(leaf, dict):
            _fill_cache(leaf, pos, gen)
        elif key == "slot_pos":
            leaf.copy_(slot_positions(leaf.shape[-1], pos, leaf.device)
                       .expand(leaf.shape))
        else:
            leaf.normal_(generator=gen)
    return cache


def _whisper_cache(cfg: ModelConfig, b: int, cache_len: int, device):
    hd = cfg.d_model // cfg.n_heads
    self_shape = (cfg.n_layers, b, cache_len, cfg.n_heads, hd)
    cross_shape = (cfg.n_layers, b, cfg.encoder_seq, cfg.n_heads, hd)
    return {"self": {"k": torch.zeros(self_shape, dtype=cfg.dt,
                                      device=device),
                     "v": torch.zeros(self_shape, dtype=cfg.dt,
                                      device=device),
                     "slot_pos": torch.full(self_shape[:3], -1,
                                            dtype=torch.int32,
                                            device=device)},
            "cross": {"k": torch.zeros(cross_shape, dtype=cfg.dt,
                                       device=device),
                      "v": torch.zeros(cross_shape, dtype=cfg.dt,
                                       device=device)}}


@dataclasses.dataclass
class DryRunCase:
    """A step and its arguments (real, or fake inside ``context``)."""
    arch: str
    shape: str
    kind: str               # train | prefill | decode | facade
    cfg: ModelConfig
    step_fn: Callable
    args: tuple
    n_tokens: int           # tokens the step processes (decode: one each)
    context: Any = None     # the FakeTensorMode of abstract arguments


def _inputs(device, abstract: bool, seed: int):
    """(device, generator, fake mode or None) of a case's arguments."""
    if abstract:
        from torch._subclasses.fake_tensor import FakeTensorMode
        return torch.device("cpu"), torch.Generator(), FakeTensorMode()
    dev = resolve(device)
    return dev, torch.Generator(dev).manual_seed(seed), None


def _detached(tree):
    return tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor)
                    else x, tree)


# --------------------------------------------------------------------------
def build_case(arch_id: str, shape_name: str, *, remat: bool = True,
               device="cuda", abstract: bool = False, seed: int = 0,
               batch: int | None = None,
               cfg: ModelConfig | None = None) -> DryRunCase:
    """The step of ``arch_id`` at ``shape_name`` and its arguments
    (``batch`` rows, default the shape's global batch; ``cfg``, default
    :func:`resolve_config`'s)."""
    cfg = cfg if cfg is not None else resolve_config(arch_id, shape_name)
    shp = INPUT_SHAPES[shape_name]
    b = shp.global_batch if batch is None else batch
    s = shp.seq_len
    dev, gen, mode = _inputs(device, abstract, seed)
    if mode is not None:
        mode.__enter__()
    try:
        return _build(arch_id, shape_name, cfg, shp.kind, b, s, remat, dev,
                      gen, mode)
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)


def _build(arch_id, shape_name, cfg, kind, b, s, remat, dev, gen, mode):
    params = api.init_params(cfg, gen)
    if kind == "train":
        opt = make_optimizer(arch_id, cfg)

        def train_step(params, opt_state, batch):
            leaves = [p.detach().requires_grad_() for p in
                      tree_leaves(params)]
            with torch.enable_grad():
                loss, metrics = api.loss_fn(
                    cfg, tree_unflatten(params, leaves), batch, remat=remat)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                ups, opt_state = opt.update(tree_unflatten(params, grads),
                                            opt_state, params)
                params = optim.apply_updates(params, ups)
            return params, opt_state, _detached(metrics)

        batch = _lm_batch(cfg, b, s, gen)
        return DryRunCase(arch_id, shape_name, kind, cfg, train_step,
                          (params, opt.init(params), batch),
                          b * batch["tokens"].shape[1], mode)

    if kind == "prefill":
        batch = _lm_batch(cfg, b, s, gen)
        if cfg.encoder_layers > 0:
            @torch.no_grad()
            def prefill_step(params, batch):
                enc = whisper.encode(cfg, params, batch["frames"])
                feats, _ = whisper.forward(cfg, params, batch["tokens"],
                                           batch["frames"])
                logits = feats[:, -1] @ whisper.lm_head_weight(params)
                return logits.float(), enc
        else:
            @torch.no_grad()
            def prefill_step(params, batch):
                return transformer.prefill(
                    cfg, params, batch["tokens"],
                    img_embeds=batch.get("img_embeds"))

        n_tok = b * (batch["tokens"].shape[1] + (
            cfg.n_image_tokens if cfg.arch_type == "vlm" else 0))
        return DryRunCase(arch_id, shape_name, kind, cfg, prefill_step,
                          (params, batch), n_tok, mode)

    # ---- decode: one new token at the context's last position ----
    if cfg.encoder_layers > 0:
        cache_len = min(s, cfg.max_decoder_len)
        cache = _whisper_cache(cfg, b, cache_len, dev)
        pos = cache_len - 1

        @torch.no_grad()
        def serve_step(params, cache, tokens, pos):
            return whisper.decode_step(cfg, params, cache, tokens, pos)
    else:
        cache_len = transformer.cache_physical_len(cfg, s)
        cache = transformer.init_cache(cfg, b, cache_len, dev)
        pos = s - 1

        @torch.no_grad()
        def serve_step(params, cache, tokens, pos):
            return transformer.decode_step(cfg, params, cache, tokens, pos)

    if mode is None:
        cache = _fill_cache(cache, pos, gen)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                           device=dev, dtype=torch.int32)
    pos_t = torch.full((b,), pos, dtype=torch.int32, device=dev)
    return DryRunCase(arch_id, shape_name, kind, cfg, serve_step,
                      (params, cache, tokens, pos_t), b, mode)


# --------------------------------------------------------------------------
def build_facade_case(arch_id: str, *, n_nodes: int = 2, k: int = 2,
                      batch_per_node: int = 16, seq: int = 4096,
                      local_steps: int = 1, remat: bool = True,
                      device="cuda", abstract: bool = False, seed: int = 0,
                      cfg: ModelConfig | None = None) -> DryRunCase:
    """The reference's FACADE step: ``n_nodes`` nodes (degree 1, lr 1e-3,
    ``local_steps`` local SGD steps) of ``arch_id``'s whole model, each
    node's batch ``batch_per_node`` sequences of ``seq`` tokens; its
    topology draw (``drawn``, the permutations of
    ``topology.draw_perms``) is an argument, as the port's round takes
    it. ``remat`` (the port's addition): the local steps recompute each
    layer in the backward pass; without it the plain attention's saved
    scores at S 4096 do not fit one card."""
    cfg = cfg if cfg is not None else get_config(arch_id)
    dev, gen, mode = _inputs(device, abstract, seed)
    if mode is not None:
        mode.__enter__()
    try:
        binding = make_binding(cfg, remat=remat)
        fcfg = facade_mod.FacadeConfig(n_nodes=n_nodes, k=k, degree=1,
                                       lr=1e-3)
        state = init_facade_state(binding, n_nodes, k, generator=gen,
                                  device=dev)
        batches = _lm_batch(cfg, batch_per_node, seq, gen,
                            lead=(n_nodes, local_steps))
        drawn = topology.draw_perms(
            torch.Generator().manual_seed(seed), n_nodes,
            fcfg.degree).to(dev)
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)

    def facade_step(state, batches, drawn):
        return facade_mod.facade_round(fcfg, binding, state, batches, drawn)

    n_tok = n_nodes * local_steps * batch_per_node * \
        batches["tokens"].shape[-1]
    return DryRunCase(arch_id, "facade_pod", "facade", cfg, facade_step,
                      (state, batches, drawn), n_tok, mode)
