"""Model bindings: the uniform interface the DL algorithms train against.

A binding exposes, over node-stacked trees (leading ``[n]``):
    init(generator)                     -> one model's full tree (head
                                           included)
    head_keys                           -> which top-level groups form the
                                           head
    node_losses(params, batch)          -> each node's mean loss ``[n]``
    loss(params, batch)                 -> their sum: the nodes' parameters
                                           are disjoint, so its gradient is
                                           each node's own
    features(core, batch)               -> the core's output per node
    select_operands(feats, heads, batch) -> the head-select kernel's
                                           ``(features, heads, labels)``
    forward(params, x)                  -> logits ``[n, B, V]`` (CNN only)

The features / head-select pair is the paper's III-E optimization: the core
runs once per round per node, and the k heads score its cached output. The
kernel takes ``[m, T, D] x [m, K', D, V]``; a binding whose heads share the
features passes ``m = n, K' = k`` (GN-LeNet), one whose heads transform the
features first passes one stream per (node, head), ``m = n * k, K' = 1``
(ResNet8, the language models); either way the result reshapes to
``[n, k]``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import localmap, resil
from repro_torch.models import cnn, layers, transformer, whisper
from repro_torch.models.base import CNNConfig, ModelConfig
from repro_torch.tree import (tree_leaves, tree_map, tree_unflatten,
                              tree_unstack)

from . import meshctx


def node_matmul(a, x):
    """The cross-node contraction ``out[i, ...] = sum_j a[i, j] x[j, ...]``.
    Under a node mesh (:mod:`.meshctx`) ``a`` holds the rank's rows
    ``[n/P, n]`` and ``x`` every sender ``[n, ...]`` (gathered once a round,
    :func:`.meshctx.gather_tree`): the product runs at ``mesh=None``'s
    shape (:func:`.meshctx.pad_rows`) and returns the rank's rows, each
    ``mesh=None``'s bit for bit."""
    if localmap.any_dtensor(a, x):
        return _node_contract("ij,j...->i...", a, (), x)
    n = x.shape[0]
    return meshctx.rows_of(
        torch.einsum("ij,j...->i...", meshctx.pad_rows(a, n), x), a)


def _node_contract(eq, a, mids, x):
    """A cross-node contraction of DTensors (an LM step's nodes on the
    'pod' axis): x gathered whole along its node dim, each rank contracting
    its shards of the other dims, the result laid out as x was."""
    lm = localmap
    ref = x if lm.is_dtensor(x) else a
    xw = lm.settle(x if lm.is_dtensor(x) else lm.like(x, ref, {}),
                   range(1, x.ndim))
    from torch.distributed.tensor import Shard

    ins = [lm.like(t, xw, {}) for t in (a, *mids)]
    shift = len(mids)               # the head slot's dim [i, c, ...]
    out_pl = tuple(Shard(p.dim + shift) if isinstance(p, Shard) else p
                   for p in xw.placements)
    out = lm.on_shards(lambda *ts: torch.einsum(eq, *ts), (*ins, xw),
                       out_pl)
    if lm.is_dtensor(x) and out.ndim == x.ndim:
        out = out.redistribute(x.device_mesh, x.placements)
    return out


def node_head_matmul(a, onehot, h):
    """FACADE's Eq. 4 receive contraction
    ``recv[i, c, ...] = sum_j a[i, j] onehot[j, c] h[j, ...]``; under a
    node mesh, the rank's rows of ``a`` against every sender's ``onehot``
    and ``h``, as :func:`node_matmul`."""
    if localmap.any_dtensor(a, onehot, h):
        return _node_contract("ij,jc,j...->ic...", a, (onehot,), h)
    n = h.shape[0]
    return meshctx.rows_of(torch.einsum(
        "ij,jc,j...->ic...", meshctx.pad_rows(a, n), onehot, h), a)


class Binding(NamedTuple):
    cfg: Any
    init: Callable
    head_keys: tuple
    node_losses: Callable
    loss: Callable
    features: Callable
    select_operands: Callable
    forward: Callable


def local_sgd(binding: Binding, params, batches, lr: float):
    """H plain-SGD steps (paper step 2d) on every node at once.

    ``batches``: a dict of ``[n, H, ...]`` leaves (``{"x", "y"}`` for a
    CNN, ``{"tokens", "labels", "mask"}`` for a language model). The loss
    is the sum of the nodes' own mean losses, so one backward pass gives
    each node its own gradient. Shared by FACADE and the baselines.
    """
    for h in range(next(iter(batches.values())).shape[1]):
        batch = {k: v[:, h] for k, v in batches.items()}
        leaves = [l.detach().requires_grad_() for l in tree_leaves(params)]
        with torch.enable_grad():
            loss = binding.loss(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        params = tree_unflatten(params, [
            (w - lr * g).to(w.dtype).detach() for w, g in zip(leaves, grads)])
    return params


def gossip_mix(w, tree, visible=None, guard=None, senders=None):
    """Row-stochastic gossip mixing (Eq. 3) ``out_i = sum_j W_ij x_j`` over
    a node-stacked tree; the one mixing definition of every algorithm.

    ``visible`` (async stale gossip and payload corruption,
    ``netwire.sent_view``): a tree of the same structure holding what each
    node's neighbours receive (a stale node exposes its last published
    snapshot, a corrupting one a mangled payload). Neighbour terms then
    read ``visible`` while each node's self term keeps its own fresh leaf:
    ``out_i = sum_j W_ij v_j + W_ii (x_i - v_i)``. With no stale node
    (``visible == tree``) the correction is exactly zero.

    ``guard`` (robust aggregation, :func:`repro_torch.resil.guard_of`):
    with a ``FaultConfig``, poisoned payloads degrade the mix instead of
    NaN'ing every receiver:

    * quarantine: a sender with any non-finite float leaf loses its
      off-diagonal weight, and each row of ``W`` is renormalised over its
      surviving neighbours (the self weight always kept);
    * norm clip: every surviving neighbour's weight is scaled by
      ``min(1, clip * |self| / |sender|)``, so a blown-up payload pulls a
      receiver by at most ``clip`` times its own norm.

    ``guard=None`` is the fault-free arithmetic bit for bit.

    Under a node mesh (:func:`.meshctx.current`) ``w`` is whole ``[n, n]``,
    ``tree`` and ``visible`` hold the rank's rows, and the senders (what
    the neighbours receive, ``visible`` or else ``tree``) are gathered
    whole once (``senders``, when the caller has gathered them already);
    each rank mixes its rows of ``w`` against every sender, and the guard
    reads every sender's finiteness and norm."""
    mesh = meshctx.current()
    lo = 0
    if mesh is not None:
        if senders is None:
            senders = meshctx.gather_tree(tree if visible is None
                                          else visible, mesh)
        lo = meshctx.row_offset(w.shape[0])
        w = meshctx.rows(w)                                    # [m, n]
    if guard is None:
        if visible is None:
            if senders is None:
                return tree_map(lambda p: node_matmul(w.to(p.dtype), p),
                                tree)
            return tree_map(lambda p, s: node_matmul(w.to(p.dtype), s),
                            tree, senders)
        diag = torch.diagonal(w, offset=lo)
        v_all = visible if senders is None else senders

        def mix(p, v, s):
            v = v.to(p.dtype)
            out = node_matmul(w.to(p.dtype), s.to(p.dtype))
            d = diag.reshape((diag.shape[0],) + (1,) * (p.dim() - 1))
            return (out + d.to(p.dtype) * (p - v)).to(p.dtype)

        return tree_map(mix, tree, visible, v_all)

    v_tree = tree if visible is None else visible
    v_all = v_tree if senders is None else senders
    n = w.shape[1]
    finite = resil.node_finite(v_all)                          # [n]
    vnorm = torch.where(finite > 0, resil.node_norm(v_all),
                        torch.ones_like(finite))
    pnorm = meshctx.rows_of(resil.node_norm(tree_map(     # own, fresh
        lambda l: meshctx.pad_rows(l, n), tree)), w)
    eye = meshctx.rows(torch.eye(n, dtype=w.dtype, device=w.device))
    off = 1.0 - eye
    # quarantine: drop poisoned senders' off-diagonal mass, renormalise
    # each row over the survivors (the self weight is always kept)
    wq = w * off * finite[None, :] + w * eye
    wr = wq / meshctx.rows_of(meshctx.pad_rows(wq, n).sum(
        dim=1, keepdim=True), w).clamp(min=1e-12)
    # norm clip: cap each neighbour's contribution at clip x own norm
    scale = torch.clamp(guard.clip * pnorm.clamp(min=1e-12)[:, None]
                        / vnorm.clamp(min=1e-12)[None, :], max=1.0)
    scale = scale * off + eye          # never clip the self term
    ws = wr * scale
    diag = torch.diagonal(wr, offset=lo)

    def mix(p, s):
        m = finite.reshape((n,) + (1,) * (p.dim() - 1))
        # zero quarantined leaves before the product: 0 weight x NaN = NaN
        vs = torch.where(m > 0, s.to(p.dtype), torch.zeros_like(s,
                                                               dtype=p.dtype))
        out = node_matmul(ws.to(p.dtype), vs)
        d = diag.reshape((diag.shape[0],) + (1,) * (p.dim() - 1))
        return (out + d.to(p.dtype) * (p - meshctx.rows(vs))).to(p.dtype)

    return tree_map(mix, tree, v_all)


def _untie_lm_head(cfg: ModelConfig, params: dict,
                  generator: torch.Generator) -> dict:
    """FACADE's head is ``final_norm`` and ``lm_head``: a model with tied
    embeddings gets its own ``lm_head``, drawn at scale 0.02."""
    if "lm_head" not in params:
        params = dict(params)
        params["lm_head"] = layers.dense_init(
            generator, cfg.d_model, cfg.vocab_size, cfg.dt, scale=0.02)
    return params


def make_binding(cfg, remat: bool = False) -> Binding:
    """The binding of ``cfg``'s model. ``remat`` (language models): the
    local steps recompute each transformer layer in the backward pass,
    the same values in less memory (``launch/steps.build_facade_case``
    needs it to fit a long sequence on one card); the CNNs ignore it."""
    if isinstance(cfg, CNNConfig):
        return _cnn_binding(cfg)
    if isinstance(cfg, ModelConfig):
        if cfg.encoder_layers > 0:
            return _whisper_binding(cfg, remat)
        return _lm_binding(cfg, remat)
    raise NotImplementedError(
        f"{type(cfg).__name__} models are not ported yet")


def _fold_bias(feats, fc: dict):
    """``feats @ w + b`` as one product: the features gain a ones column
    and the weight the bias as an extra row, ``[..., T, D+1]`` and
    ``[..., D+1, V]``."""
    ones = torch.ones(feats.shape[:-1] + (1,), dtype=feats.dtype,
                      device=feats.device)
    f = torch.cat([feats, ones], dim=-1)
    w = torch.cat([fc["w"], fc["b"].unsqueeze(-2)], dim=-2)
    return f.contiguous(), w.to(f.dtype).contiguous()


def _cnn_binding(cfg: CNNConfig) -> Binding:
    hk = cnn.head_keys(cfg)

    def node_losses(params, batch):
        return cnn.node_losses(cfg, params, batch)

    def loss(params, batch):
        return node_losses(params, batch).sum()

    def features(core, batch):
        """LeNet ``[n, B, D]``; ResNet8 NHWC ``[n, B, H, W, C]``."""
        return cnn.node_features(cfg, core, batch["x"])

    def select_operands(feats, heads, batch):
        """The kernel scores ``fc`` only, with its bias folded in.

        LeNet's heads share the features: ``[n, B, D+1]`` and
        ``[n, k, D+1, V]``. ResNet8's head runs block2 and block3 first,
        which differ per head: one grouped pass of all ``n*k`` (node, head)
        streams on their node's features, mean-pooled, so the kernel gets
        ``[n*k, B, 4C+1]``, ``[n*k, 1, 4C+1, V]`` and labels ``[n*k, B]``."""
        y = batch["y"].to(torch.int32)
        if cfg.kind == "lenet":
            return _fold_bias(feats, heads["fc"]) + (y,)
        n, k = heads["fc"]["w"].shape[:2]
        streams = feats.unsqueeze(1).expand((n, k) + feats.shape[1:])
        flat = tree_map(lambda l: l.flatten(0, 1), heads)
        pooled = cnn.resnet8_node_pooled(cfg, flat, streams.flatten(0, 1))
        f, w = _fold_bias(pooled, flat["fc"])
        labels = y.unsqueeze(1).expand(n, k, -1).reshape(n * k, -1)
        return f, w.unsqueeze(1), labels.contiguous()

    def forward(params, x):
        return cnn.node_forward(cfg, params, x)

    return Binding(cfg, lambda g: cnn.init_params(cfg, g), hk, node_losses,
                   loss, features, select_operands, forward)


def _lm_select_operands(norm):
    """Step 2c's operands for a language model whose head is a final norm
    (``norm(feats, final_norm)``) and an ``lm_head``: head j of node i
    scores ``norm(feats_i, final_norm[i, j]) @ lm_head[i, j]``. The norm
    differs per head, so the kernel gets one normed stream per (node,
    head), rounded to the param dtype as the norm rounds it: ``[n*k, B*S,
    D]``, the heads as a view ``[n*k, 1, D, V]`` and labels ``[n*k, B*S]``
    with the masked positions at -1."""
    def select_operands(feats, heads, batch):
        n, k = heads["lm_head"].shape[:2]
        f = norm(feats.reshape(n, 1, -1, feats.shape[-1]),
                 tree_map(lambda g: g[:, :, None, :], heads["final_norm"]))
        labels = torch.where(batch["mask"] > 0, batch["labels"],
                             torch.full_like(batch["labels"], -1))
        labels = labels.reshape(n, 1, -1).expand(n, k, -1)
        return (f.reshape(n * k, -1, f.shape[-1]).contiguous(),
                heads["lm_head"].reshape((n * k, 1) +
                                         heads["lm_head"].shape[2:]),
                labels.reshape(n * k, -1).to(torch.int32).contiguous())

    return select_operands


def _no_forward(params, x):
    raise NotImplementedError(
        "per-node logits of a language model are not ported yet; "
        "evaluate with binding.loss")


def _node_batch(batch, i: int) -> dict:
    return {key: b[i] for key, b in batch.items()}


def _lm_binding(cfg: ModelConfig, remat: bool = False) -> Binding:
    """A decoder LM under FACADE: the head is ``final_norm`` and an untied
    ``lm_head``; the core's output is the pre-norm features of the text
    positions (a VLM's batch also holds ``img_embeds`` [n, B, n_img, D])."""
    hk = ("final_norm", "lm_head")

    def init(generator):
        return _untie_lm_head(cfg, transformer.init_params(cfg, generator),
                              generator)

    def node_losses(params, batch):
        return torch.stack([transformer.loss_fn(
            cfg, node_params, _node_batch(batch, i), remat=remat)[0]
            for i, node_params in enumerate(tree_unstack(params))])

    def loss(params, batch):
        return node_losses(params, batch).sum()

    def features(core, batch):
        """[n, B, S, D] pre-norm features of the text positions, one
        forward per node."""
        img = batch.get("img_embeds")
        n_img = 0 if img is None else img.shape[2]
        return torch.stack([
            transformer.forward(cfg, node_core, batch["tokens"][i],
                                img_embeds=None if img is None else img[i],
                                apply_final_norm=False)[0][:, n_img:]
            for i, node_core in enumerate(tree_unstack(core))])

    def norm(f, g):
        return layers.rms_norm(f, g, cfg.norm_eps)

    return Binding(cfg, init, hk, node_losses, loss, features,
                   _lm_select_operands(norm), _no_forward)


def _whisper_binding(cfg: ModelConfig, remat: bool = False) -> Binding:
    """The encoder-decoder under FACADE: the head is ``final_norm`` (a
    LayerNorm's ``g`` and ``b``) and an untied ``lm_head``; the core is
    the encoder and the decoder, whose output is the pre-norm decoder
    features. The batch holds ``frames`` [n, B, S_enc, D]."""
    hk = ("final_norm", "lm_head")

    def init(generator):
        return _untie_lm_head(cfg, whisper.init_params(cfg, generator),
                              generator)

    def node_losses(params, batch):
        return torch.stack([whisper.loss_fn(
            cfg, node_params, _node_batch(batch, i), remat=remat)[0]
            for i, node_params in enumerate(tree_unstack(params))])

    def loss(params, batch):
        return node_losses(params, batch).sum()

    def features(core, batch):
        """[n, B, S, D] pre-norm decoder features, one forward per node."""
        return torch.stack([
            whisper.forward(cfg, node_core, batch["tokens"][i],
                            batch["frames"][i], apply_final_norm=False)[0]
            for i, node_core in enumerate(tree_unstack(core))])

    def norm(f, g):
        return layers.layer_norm(f, g["g"], g["b"], cfg.norm_eps)

    return Binding(cfg, init, hk, node_losses, loss, features,
                   _lm_select_operands(norm), _no_forward)
