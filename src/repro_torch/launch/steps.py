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

On a mesh (``mesh=``, a ``DeviceMesh`` with the reference's axis names,
``launch.mesh``) the arguments are DTensors laid out by
``launch.shardings``' specs, as the reference's ``in_shardings``:
parameters by ``param_specs(fsdp=)``, optimizer slots by ``opt_specs``,
the batch by ``batch_specs``, a decode's cache by ``cache_specs`` and its
tokens and positions on 'data' where the batch divides. Real tensors are
drawn on every rank from the same seed, the values of ``mesh=None``'s
draw, and each rank keeps its shards (a transformer's parameters leaf by
leaf, one layer at a time, so no rank holds the whole model); fake tensors
are wrapped shard by shard. The step then runs with the activation hooks
the reference installs (``models.hooks``: the batch on ('pod',) 'data',
heads on 'model'; ``seq_model`` only for training and not for RWKV, whose
sequence is its recurrence) and with plain tensors made inside the step
(positions, masks, scalars) taken as replicated. ``mesh=None`` is the
single-card case, bit for bit.

Left out of the reference's signatures: ``unroll`` (the port's layers are
a Python loop, so there is no scan to unroll and every layer is counted).
Added: ``batch``, ``cfg`` and ``seq``, through which a caller runs a
step cut in batch, depth or length (the default is the input shape's
batch and length and :func:`resolve_config`'s model), and ``remat`` and
``head_jitter`` on the FACADE case.
"""
from __future__ import annotations

import dataclasses
import functools
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
from repro_torch.models import api, hooks, transformer, whisper
from repro_torch.models.base import ModelConfig, get_config
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from . import shardings

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
    mesh: Any = None        # the DeviceMesh of DTensor arguments


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
               batch: int | None = None, cfg: ModelConfig | None = None,
               seq: int | None = None, mesh=None, fsdp: bool = True, act_sharding: bool = True,
               seq_model: bool = False) -> DryRunCase:
    """The step of ``arch_id`` at ``shape_name`` and its arguments
    (``batch`` rows, default the shape's global batch; ``cfg``, default
    :func:`resolve_config`'s; ``seq`` positions, default the shape's), on
    one device or over ``mesh`` (module docstring)."""
    cfg = cfg if cfg is not None else resolve_config(arch_id, shape_name)
    shp = INPUT_SHAPES[shape_name]
    b = shp.global_batch if batch is None else batch
    s = shp.seq_len if seq is None else seq
    dev, gen, mode = _inputs(device, abstract, seed)
    init = api.init_params
    if mesh is not None:
        init = functools.partial(init_params_on_mesh, mesh=mesh, fsdp=fsdp)
    if mode is not None:
        mode.__enter__()
    try:
        case = _build(arch_id, shape_name, cfg, shp.kind, b, s, remat, dev,
                      gen, mode, init)
        if mesh is None:
            return case
        return _on_mesh(case, mesh, fsdp=fsdp, act_sharding=act_sharding,
                        seq_model=seq_model)
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)


def init_params_on_mesh(cfg: ModelConfig, gen: torch.Generator, mesh, *,
                        fsdp: bool = True):
    """``api.init_params(cfg, gen)``'s values as DTensors over ``mesh``
    laid out by ``shardings.param_specs``: a transformer's leaves cut to
    this rank's shards as ``init_params`` draws them (its ``place``), so a
    rank holds its shards and one layer; whisper's drawn whole and
    distributed."""
    if api.is_encdec(cfg):
        params = api.init_params(cfg, gen)
        return shardings.distribute(params, mesh, shardings.param_specs(
            params, mesh, fsdp=fsdp))

    def place(leaf, path):
        # a layer's leaf by its stack's rule (the stacked shape, the layer
        # dim whole)
        lead = (cfg.n_layers,) if path.startswith("layers/") else ()
        spec = shardings.leaf_spec(path, lead + tuple(leaf.shape), mesh,
                                   fsdp=fsdp, skip_leading=len(lead))
        return shardings.distribute(leaf, mesh, spec[len(lead):])

    return transformer.init_params(cfg, gen, place=place)


def _hook_axes(mesh, act_sharding: bool, seq_model: bool, kind: str,
               cfg: ModelConfig):
    """The reference's activation hooks for a case (``build_case``):
    ``(batch_axes, model_axis, seq_model)``, or all off."""
    if not act_sharding:
        return (None, None, False)
    axes = shardings.axis_sizes(mesh)
    batch_axes = ("pod", "data") if "pod" in axes else ("data",)
    return (batch_axes, "model", seq_model and not cfg.rwkv
            and kind == "train")


def mesh_step(step_fn, hook_axes):
    """``step_fn`` run with the case's hooks installed and the plain
    tensors it makes taken as replicated DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        with hooks.installed(*hook_axes), implicit_replication():
            return step_fn(*args)

    return run


def _on_mesh(case: DryRunCase, mesh, *, fsdp: bool, act_sharding: bool,
             seq_model: bool) -> DryRunCase:
    """A case's arguments laid out over ``mesh`` by the reference's specs
    (parameters that are DTensors already stay as they are)."""
    pspecs = shardings.param_specs(case.args[0], mesh, fsdp=fsdp)
    params = shardings.distribute(case.args[0], mesh, pspecs)
    if case.kind == "train":
        _, opt_state, batch = case.args
        args = (params,
                shardings.distribute(opt_state, mesh, shardings.opt_specs(
                    opt_state, pspecs)),
                shardings.distribute(batch, mesh, shardings.batch_specs(
                    batch, mesh)))
    elif case.kind == "prefill":
        batch = case.args[1]
        args = (params, shardings.distribute(batch, mesh,
                                             shardings.batch_specs(batch,
                                                                   mesh)))
    else:
        _, cache, tokens, pos = case.args
        b = tokens.shape[0]
        dsize = shardings.axis_sizes(mesh).get("data", 1)
        on_data = "data" if b % dsize == 0 and b >= dsize else None
        args = (params,
                shardings.distribute(cache, mesh, shardings.cache_specs(
                    cache, mesh)),
                shardings.distribute(tokens, mesh, (on_data, None)),
                shardings.distribute(pos, mesh, (on_data,)))
    axes = _hook_axes(mesh, act_sharding, seq_model, case.kind, case.cfg)
    return dataclasses.replace(case, step_fn=mesh_step(case.step_fn, axes),
                               args=args, mesh=mesh)


def _build(arch_id, shape_name, cfg, kind, b, s, remat, dev, gen, mode,
           init=api.init_params):
    params = init(cfg, gen)
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
                      cfg: ModelConfig | None = None, mesh=None,
                      act_sharding: bool = True,
                      head_jitter: float = 0.0) -> DryRunCase:
    """The reference's FACADE step: ``n_nodes`` nodes (degree 1, lr 1e-3,
    ``local_steps`` local SGD steps) of ``arch_id``'s whole model, each
    node's batch ``batch_per_node`` sequences of ``seq`` tokens; its
    topology draw (``drawn``, the permutations of
    ``topology.draw_perms``) is an argument, as the port's round takes
    it. ``remat`` (the port's addition): the local steps recompute each
    layer in the backward pass; without it the plain attention's saved
    scores at S 4096 do not fit one card. ``head_jitter`` (the port's
    addition, as ``init_facade_state``'s): the k heads start apart, so
    that step 2c's choice is no tie.

    On a mesh the node axis lies on 'pod' (where the mesh has it): the
    cores by ``param_specs(node_axis=True)``, the heads' ``[n, k, ...]``
    leaves with ``extra_leading=(pod, None)``, the cluster ids on 'pod'
    and each node's batch on 'data'; the hooks put the batch within a
    node on 'data' only, with ``seq_model`` (the reference's choice)."""
    cfg = cfg if cfg is not None else get_config(arch_id)
    dev, gen, mode = _inputs(device, abstract, seed)
    if mode is not None:
        mode.__enter__()
    try:
        binding = make_binding(cfg, remat=remat)
        fcfg = facade_mod.FacadeConfig(n_nodes=n_nodes, k=k, degree=1,
                                       lr=1e-3)
        state = init_facade_state(binding, n_nodes, k, generator=gen,
                                  head_jitter=head_jitter, device=dev)
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
    if mesh is None:
        return DryRunCase(arch_id, "facade_pod", "facade", cfg, facade_step,
                          (state, batches, drawn), n_tok, mode)
    if mode is not None:
        mode.__enter__()
    try:
        state, batches = _facade_on_mesh(state, batches, mesh)
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)
    axes = (("data",), "model", True) if act_sharding else (None, None,
                                                            False)
    return DryRunCase(arch_id, "facade_pod", "facade", cfg,
                      mesh_step(facade_step, axes),
                      (state, batches, drawn), n_tok, mode, mesh)


def _facade_on_mesh(state, batches, mesh):
    """The FACADE state and batches laid out as the reference's
    ``build_facade_case`` lays them out (``build_facade_case``)."""
    axes = shardings.axis_sizes(mesh)
    pod = "pod" if "pod" in axes else None
    core_specs = shardings.param_specs(state.cores, mesh, fsdp=True,
                                       node_axis=True)
    head_specs = shardings._map_with_path(
        lambda ps, leaf: shardings.leaf_spec(
            ps, leaf.shape, mesh, fsdp=True, skip_leading=0,
            extra_leading=(pod, None)), state.heads)
    on_data = "data" if batches["tokens"].shape[2] % axes.get(
        "data", 1) == 0 else None
    state = state._replace(
        cores=shardings.distribute(state.cores, mesh, core_specs),
        heads=shardings.distribute(state.heads, mesh, head_specs),
        cluster_id=shardings.distribute(state.cluster_id, mesh, (pod,)))
    batches = shardings.distribute(
        batches, mesh, {key: (pod, None, on_data, None) for key in batches})
    return state, batches
