"""Model bindings: the uniform interface the DL algorithms train against.

A binding exposes, over node-stacked trees (leading ``[n]``):
    init(generator)              -> one model's full tree (head included)
    head_keys                    -> which top-level groups form the head
    loss(params, batch)          -> sum over nodes of each node's mean loss
    features(core, x)            -> core activations ``[n, B, D]``
    select_operands(feats, heads) -> the head-select kernel's operands
    forward(params, x)           -> logits ``[n, B, V]``

The features / head-select pair is the paper's III-E optimization: the core
runs once per round per node, and the k heads score its cached output.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import cnn
from repro_torch.models.base import CNNConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def node_matmul(a, x):
    """The cross-node contraction ``out[i, ...] = sum_j a[i, j] x[j, ...]``."""
    return torch.einsum("ij,j...->i...", a, x)


def node_head_matmul(a, onehot, h):
    """FACADE's Eq. 4 receive contraction
    ``recv[i, c, ...] = sum_j a[i, j] onehot[j, c] h[j, ...]``."""
    return torch.einsum("ij,jc,j...->ic...", a, onehot, h)


class Binding(NamedTuple):
    cfg: Any
    init: Callable
    head_keys: tuple
    loss: Callable
    features: Callable
    select_operands: Callable
    forward: Callable


def local_sgd(binding: Binding, params, batches, lr: float):
    """H plain-SGD steps (paper step 2d) on every node at once.

    ``batches``: ``{"x": [n, H, B, ...], "y": [n, H, B]}``. The loss is the
    sum of the nodes' own mean losses, so one backward pass gives each node
    its own gradient. Shared by FACADE and the baselines.
    """
    for h in range(batches["y"].shape[1]):
        batch = {k: v[:, h] for k, v in batches.items()}
        leaves = [l.detach().requires_grad_() for l in tree_leaves(params)]
        with torch.enable_grad():
            loss = binding.loss(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
        params = tree_unflatten(params, [
            (w - lr * g).to(w.dtype).detach() for w, g in zip(leaves, grads)])
    return params


def gossip_mix(w, tree):
    """Row-stochastic gossip mixing (Eq. 3) ``out_i = sum_j W_ij x_j`` over
    a node-stacked tree; the one mixing definition of every algorithm."""
    return tree_map(lambda p: node_matmul(w.to(p.dtype), p), tree)


def make_binding(cfg) -> Binding:
    if isinstance(cfg, CNNConfig):
        return _cnn_binding(cfg)
    raise NotImplementedError(
        f"{type(cfg).__name__} models are not ported yet; the port runs "
        "the paper's CNNs")


def _cnn_binding(cfg: CNNConfig) -> Binding:
    hk = cnn.head_keys(cfg)

    def loss(params, batch):
        return cnn.node_loss(cfg, params, batch)

    def features(core, x):
        return cnn.node_features(cfg, core, x)

    def select_operands(feats, heads):
        """LeNet's head is ``feats @ w + b``; the bias folds into the
        kernel's weight as an extra row, against a ones column of the
        features: ``[n, B, D+1]`` and ``[n, K, D+1, V]``."""
        fc = heads["fc"]
        ones = torch.ones(feats.shape[:-1] + (1,), dtype=feats.dtype,
                          device=feats.device)
        f = torch.cat([feats, ones], dim=-1)
        w = torch.cat([fc["w"], fc["b"].unsqueeze(-2)], dim=-2)
        return f.contiguous(), w.to(f.dtype).contiguous()

    def forward(params, x):
        return cnn.node_forward(cfg, params, x)

    return Binding(cfg, lambda g: cnn.init_params(cfg, g), hk, loss,
                   features, select_operands, forward)
