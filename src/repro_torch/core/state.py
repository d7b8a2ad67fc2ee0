"""Stacked decentralized-learning state.

Every node's parameters live in one tree with a leading ``node`` axis,
which makes gossip an einsum. Heads carry an extra ``k`` axis (one slot
per cluster). Unlike the reference, the state holds no PRNG key: the
round functions take their random draws as inputs.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import device as device_mod
from repro_torch.netsim import tree_select
from repro_torch.tree import tree_map

from . import meshctx, split


class FacadeState(NamedTuple):
    cores: Any           # tree, leading [n, ...]
    heads: Any           # tree, leading [n, k, ...]
    cluster_id: Any      # [n] int64 — cluster ID reported last round
    round: int


class BaselineState(NamedTuple):
    params: Any          # tree, leading [n, ...] (full model)
    round: int
    extra: Any = None    # algorithm state (DAC: {"sim": [n, n]})


class EngineCarry(NamedTuple):
    """What the segment engine (``core/engine.py``) carries from one
    segment to the next, each tensor one of the engine's static buffers
    (overwritten in place round by round): the algorithm state and, under
    network simulation (``net=``), the Gilbert–Elliott channel
    (``netsim.ChannelState``, bursty presets), the async-gossip staleness
    buffer (``netsim.GossipState``, ``async_gossip``) and the node-crash
    chain (``resil.FaultState``, ``net.faults`` with ``crash_rate > 0``:
    ``down [n]`` and, under ``restart_mode="reset"``, the copy of the
    round-0 state restarted nodes return to), and, under an adaptive
    topology policy (``topo=``, with or without ``net``), its per-link
    EWMAs (``topo.TopoState``, ``delivery`` and ``link_s`` ``[n, n]``);
    each is ``None`` where the run has none. A segment's drawn inputs are
    not carried: the engine draws them at the segment's start from the
    run's draws source, where the reference's carry holds its data PRNG
    key."""
    state: Any           # FacadeState | BaselineState
    chan: Any = None     # netsim.ChannelState | None
    gossip: Any = None   # netsim.GossipState | None
    fault: Any = None    # resil.FaultState | None
    topo: Any = None     # topo.TopoState | None (uniform policy or off)


def _stack_n(tree, n: int, dev):
    return tree_map(
        lambda l: l.to(dev).unsqueeze(0).expand((n,) + l.shape).clone(),
        tree)


def init_facade_state(binding, n: int, k: int, *, params=None,
                      heads_k=None, generator: torch.Generator | None = None,
                      head_jitter: float = 0.0,
                      device="cuda") -> FacadeState:
    """All nodes start from the same model (paper: 'initializing its local
    model in the same way'); the k heads share weights unless
    ``head_jitter`` decorrelates them.

    ``params`` (one model's full tree) and ``heads_k`` (its ``[k, ...]``
    head bank) may be given, e.g. converted from the reference with
    ``interop``; what is not given is drawn from ``generator``.
    """
    dev = device_mod.resolve(device)
    if generator is None and (params is None or heads_k is None):
        raise ValueError("params and heads_k not given: pass the "
                         "torch.Generator to draw them from")
    if params is None:
        params = binding.init(generator)
    core, head = split.split_params(params, binding.head_keys)
    if heads_k is None:
        heads_k = split.stack_heads(head, k, generator=generator,
                                    jitter=head_jitter)
    return FacadeState(
        cores=_stack_n(core, n, dev),
        heads=_stack_n(heads_k, n, dev),
        cluster_id=torch.zeros((n,), dtype=torch.long, device=dev),
        round=0)


def init_baseline_state(binding, n: int, *, params=None,
                        generator: torch.Generator | None = None,
                        extra=None, device="cuda") -> BaselineState:
    dev = device_mod.resolve(device)
    if params is None:
        if generator is None:
            raise ValueError("params not given: pass the torch.Generator "
                             "to draw them from")
        params = binding.init(generator)
    return BaselineState(params=_stack_n(params, n, dev), round=0,
                         extra=None if extra is None else tree_map(
                             lambda l: l.to(dev), extra))


def freeze_inactive(active, new_tree, old_tree):
    """Churn semantics: nodes with ``active == 0`` sat the round out, so
    every leaf keeps its old value along the leading node axis (under a
    node mesh, the trees hold the rank's rows of the whole ``active``)."""
    return tree_select(meshctx.rows(active), new_tree, old_tree)
