"""Core/head parameter split (paper Sec. III-A).

The model tree is split by top-level key: the config names which groups
form the FACADE head (``("fc",)`` for GN-LeNet); everything else is the
shared core. Heads are replicated k times (one per cluster); cores stay
single. Node-stacked trees carry ``[n]`` in front and heads ``[n, k]``.
"""
from __future__ import annotations

import torch

from repro_torch import localmap
from repro_torch.tree import tree_leaves, tree_map


def split_params(params: dict, head_keys: tuple):
    head = {k: params[k] for k in head_keys if k in params}
    core = {k: v for k, v in params.items() if k not in head}
    return core, head


def merge_params(core: dict, head: dict) -> dict:
    out = dict(core)
    out.update(head)
    return out


def stack_heads(head: dict, k: int, generator: torch.Generator | None = None,
                jitter: float = 0.0) -> dict:
    """Replicate one model's head tree k times -> leading axis k. Optional
    ``jitter`` decorrelates the copies with normal noise drawn from
    ``generator``; ``jitter=0`` reproduces the paper's shared-init strategy
    (Appendix F)."""
    def rep(leaf):
        return leaf.unsqueeze(0).expand((k,) + leaf.shape).clone()

    stacked = tree_map(rep, head)
    if jitter > 0.0:
        if generator is None:
            raise ValueError("head jitter needs a torch.Generator")
        stacked = tree_map(
            lambda l: l + jitter * torch.randn(
                l.shape, generator=generator, dtype=l.dtype,
                device=generator.device).to(l.device), stacked)
    return stacked


def select_head(stacked_head: dict, idx) -> dict:
    """Node-stacked heads ``[n, k, ...]`` and ``idx [n]`` -> ``[n, ...]``,
    node i's slot ``idx[i]``."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    return tree_map(lambda l: l[rows, idx], stacked_head)


def set_head(stacked_head: dict, idx, head: dict) -> dict:
    """Write node i's ``head[i]`` into its slot ``idx[i]`` of the
    node-stacked ``[n, k, ...]`` bank; returns a new bank. On DTensors
    each rank writes into its shards of the bank (the slot dim whole,
    ``head`` laid out as the bank's other dims): the card's DTensor (torch
    2.11) has no rule for the index assignment."""
    def put(s, h):
        if localmap.is_dtensor(s):
            return _put_on_shards(s, h, idx)
        out = s.clone()
        out[torch.arange(idx.shape[0], device=idx.device), idx] = \
            h.to(s.dtype)
        return out

    return tree_map(put, stacked_head, head)


def _put_on_shards(s, h, idx):
    """:func:`set_head`'s write of one leaf, rank by rank."""
    lm = localmap
    s = lm.settle(s, [d for d in range(s.ndim) if d != 1], "head bank")
    h = lm.like(h, s, {0: 0, **{d: d - 1 for d in range(2, s.ndim)}})
    idx = lm.like(idx, s, {0: 0})
    return lm.on_shards(
        lambda sl, hl, il: set_head({"h": sl}, il, {"h": hl})["h"],
        (s, h, idx), tuple(s.placements))


def tree_size_bytes(tree) -> int:
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))
