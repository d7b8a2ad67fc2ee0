"""Asynchronous stale gossip: stragglers serve snapshots, not stalls. The
port of ``repro.netsim.gossip``.

In a synchronous round every straggler stretches the round. Under
``NetworkConfig(async_gossip=True)`` a slow node keeps computing while its
neighbours reuse the last model it *published*:

* :class:`GossipState` — the staleness buffer carried by both drivers (on
  the engine, static buffers of its carry): ``published`` holds every
  node's last published mixable state (the params for the baselines; the
  cores, heads and cluster id for FACADE) and ``age [n]`` counts rounds
  since each node last published.
* Per round a straggling node *stays stale* while ``age + 1 <=
  cfg.max_staleness``: its neighbours mix against ``published``
  (``bindings.gossip_mix``), it sends no fresh bytes and it does not gate
  the simulated round time. At the cap it publishes fresh state and gates
  the round like a synchronous straggler.
* ``max_staleness=0`` forces every node fresh every round: the async path
  is the synchronous one bit for bit (mixing, bytes and seconds).

A node's own training is never stale; only what its neighbours observe
lags.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class GossipState(NamedTuple):
    """Staleness buffer, one entry per node (leading ``n`` axis)."""
    published: Any       # tree: each node's last published mixable state
    age: Any             # [n] int32: rounds since the node last published


def tree_select(mask, when_on, when_off):
    """Per-node select along the leading axis: ``mask[i] > 0`` picks
    ``when_on``'s node-i leaves, else ``when_off``'s. Shared by the
    staleness machinery, ``netwire.stale_view`` and
    ``state.freeze_inactive``."""
    def pick(a, b):
        m = mask.reshape((mask.shape[0],) + (1,) * (a.dim() - 1))
        return torch.where(m > 0, a, b).to(a.dtype)
    return tree_map(pick, when_on, when_off)


def init_gossip(cfg, n: int, mixable):
    """A fresh buffer from the run's initial state (``None`` when async
    gossip is off). ``mixable`` is copied leaf for leaf, so the buffer
    never aliases the training state."""
    if cfg is None or not cfg.async_gossip:
        return None
    leaf = tree_leaves(mixable)[0]
    return GossipState(published=tree_map(torch.clone, mixable),
                       age=torch.zeros((n,), dtype=torch.int32,
                                       device=leaf.device))


def stale_mask(cfg, conds, gossip):
    """{0,1} ``[n]``: 1 where the node stays stale this round — a
    straggler whose snapshot would still be within ``max_staleness``."""
    within = gossip.age + 1 <= cfg.max_staleness
    return (conds.straggler * within).to(torch.float32)


def apply_async(cfg, conds, gossip):
    """Pre-round hook of both drivers: ``(conds', published)``. With async
    gossip, ``conds'`` carries the round's ``stale`` mask and
    ``published`` is the buffer tree to hand the round function
    (``gossip=``); otherwise the conditions pass through and
    ``published`` is ``None``, the synchronous path."""
    if cfg is None or gossip is None or not cfg.async_gossip:
        return conds, None
    return (conds._replace(stale=stale_mask(cfg, conds, gossip)),
            gossip.published)


def fold_gossip(cfg, gossip, conds, new_mixable, stay_rows=None):
    """Post-round hook: nodes that stayed stale keep their old snapshot and
    age by one; every other node publishes the round's fresh mixable state
    and resets to age 0. ``stay_rows``: where ``published`` and
    ``new_mixable`` hold a block of the nodes (a node mesh), that block's
    rows of the stale mask; ``None``, the whole mask."""
    if gossip is None:
        return None
    stay = conds.stale
    published = tree_select(stay if stay_rows is None else stay_rows,
                            gossip.published, new_mixable)
    age = torch.where(stay > 0, gossip.age + 1,
                      torch.zeros_like(gossip.age)).to(torch.int32)
    return GossipState(published=published, age=age)
