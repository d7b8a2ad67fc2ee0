"""Shared network-simulation plumbing of every round function (FACADE and
the baselines), the port of ``repro.core.netwire``.

Each algorithm's round follows one contract: draw its topology, filter it
through the round's network conditions, and, when a
``netsim.RoundConditions`` is given, report the effective adjacency and
the per-message payload, from which the drivers compute the round's
simulated seconds. Keeping it here means a new algorithm needs no
netsim-specific code, and the byte accounting lives in one place.

Under async gossip (``conds.stale`` set; ``None`` on every synchronous
path):

* :func:`stale_view` is the per-node tree neighbours observe (stale nodes
  expose their published snapshot), fed to ``bindings.gossip_mix``;
* :func:`comm_info` counts no fresh bytes for what a stale node "sends":
  its neighbours reuse the copy they hold;
* :func:`round_seconds` drops stale nodes from the round's gating set.

Node faults (:mod:`repro_torch.resil`) ride the same contracts:
:func:`sent_view` composes the stale view with per-sender payload
corruption, and crashed nodes need no accounting of their own. Offline
and crashed nodes are ``active == 0``, which zeroes their directed edges
in ``effective_adjacency`` (0 bytes), and ``round_time``'s ``active``
product keeps them out of the gating set.

An adaptive topology policy (:mod:`repro_torch.topo`) rides the same
entry point: :func:`net_round` folds each round's conditions into its
EWMAs, and :func:`comm_info` counts the drawn graph's edges
(``actual=True``) even on the ideal medium.

Under a node mesh (:mod:`.meshctx`) the node-stacked trees hold the
rank's rows while the round's conditions, the adjacency, the crash chain,
the gossip ages and the policy's EWMAs stay whole on every rank (they
stand in for the reference's ``meshctx.constrain_rows``): the per-node
selects here take the rank's rows of the whole masks, and the bytes and
seconds are computed from the whole tensors, so they are ``mesh=None``'s
exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import netsim, resil
from repro_torch import topo as topo_mod

from . import meshctx, topology


def masked_topology(net, adj):
    """The round's drop and churn masks applied to ``adj`` (the identity
    when ``net is None``)."""
    if net is None:
        return adj
    return topology.effective_adjacency(adj, net.edge_mask, net.active)


def stale_view(net, published, fresh):
    """The node-stacked tree neighbours observe under async gossip: the
    published snapshot where ``net.stale == 1``, the fresh leaves
    elsewhere. ``None`` (everyone fresh: the plain mixing path) whenever
    async gossip is off or no buffer was given."""
    if net is None or published is None or net.stale is None:
        return None
    return netsim.tree_select(meshctx.rows(net.stale), published, fresh)


def sent_view(net, published, fresh, fault_cfg=None):
    """What each node's neighbours receive this round: the stale view
    (:func:`stale_view`) composed with per-sender payload corruption
    (:func:`repro_torch.resil.corrupt_view`). A corrupting node mangles
    whatever it delivers, fresh state or stale snapshot; its own state is
    untouched. ``None`` (the plain mixing path) when both are off, so
    every zero-rate off-switch keeps the fault-free arithmetic."""
    vis = stale_view(net, published, fresh)
    if (fault_cfg is None or fault_cfg.corrupt_rate <= 0
            or net is None or net.corrupt is None):
        return vis
    if meshctx.current() is not None:
        # the rank's rows of the mask (the engine keeps the noise's rows)
        net = net._replace(corrupt=meshctx.rows(net.corrupt))
    return resil.corrupt_view(fault_cfg, net, fresh if vis is None else vis)


def gather_sent(tree):
    """Under a node mesh, what every node sends (``tree``, the rank's rows)
    gathered whole in one collective, for ``bindings.gossip_mix(senders=)``
    and :func:`quarantined`; ``None`` without a mesh."""
    if meshctx.current() is None:
        return None
    return meshctx.gather_tree(tree)


def quarantined(guard, vis, senders, device):
    """``resil.quarantined_count`` over every sender: the gathered
    ``senders`` under a node mesh, what was delivered (``vis``)
    otherwise."""
    return resil.quarantined_count(
        guard, vis if vis is None or senders is None else senders,
        device=device)


def comm_info(net, adj_eff, payload_bytes: int, nominal_sends: int,
              actual: bool = False) -> dict:
    """The round's bytes, and what the timing model needs.

    Without netsim, the nominal count (``n * degree`` directed pushes) as
    a host float, held as float32 as the reference holds it, unless
    ``actual`` is set (an adaptive topology policy: the drawn graph
    varies a round, so the bytes count its directed edges even on the
    ideal medium, a float32 0-d tensor on the round's device). Under
    netsim, the directed edges that carried a message this round, a
    float32 0-d tensor (their float32 count times the payload); under
    async gossip the edges out of a stale node carry no new bytes, so its
    rows are left out. ``adj_eff`` and ``payload_bytes`` ride along for
    :func:`round_seconds`."""
    if net is None:
        if actual:
            return {"round_bytes": adj_eff.sum() * payload_bytes,
                    "adj_eff": adj_eff, "payload_bytes": payload_bytes}
        return {"round_bytes": float(np.float32(nominal_sends
                                                * payload_bytes)),
                "adj_eff": adj_eff, "payload_bytes": payload_bytes}
    sends = adj_eff
    if net.stale is not None:
        sends = adj_eff * (1.0 - net.stale)[:, None]
    return {"round_bytes": sends.sum() * payload_bytes, "adj_eff": adj_eff,
            "payload_bytes": payload_bytes}


def round_seconds(net, info: dict, conds, local_steps: int, tiers=None):
    """Simulated wall-clock of one round from its :func:`comm_info`, a
    float32 0-d tensor on the round's device (``0.0`` when netsim is off).
    ``tiers``: the node tiers (``NetDraws.tiers``), needed iff
    ``net.classes`` is set. Stale nodes (async gossip) leave the gating
    set: only nodes that must finish this round can stretch it."""
    if net is None:
        return 0.0
    active = conds.active
    adj_gate = info["adj_eff"]
    if conds.stale is not None:
        # stale nodes neither gate the round nor make anyone wait on a
        # transfer: receivers reuse the cached snapshot (column mask), and
        # the stale node's own compute overlaps later rounds (gate)
        active = active * (1.0 - conds.stale)
        adj_gate = adj_gate * (1.0 - conds.stale)[None, :]
    payload = torch.full((), float(info["payload_bytes"]),
                         dtype=torch.float32, device=adj_gate.device)
    return netsim.round_time(net, adj_gate, payload, active, conds.straggler,
                             local_steps=local_steps, tiers=tiers)


def topo_kw(topo) -> dict:
    """The round closure's ``topo=`` argument: the policy's
    ``TopoState``, passed only under an adaptive policy, so a closure
    written without one keeps its signature."""
    return {} if topo is None else {"topo": topo}


def net_round(fn, mixable_of, state, chan, gossip, fault, batches,
              topology_args: tuple, net, draws, local_steps: int,
              topo_cfg=None, topo=None, frame=None):
    """One round of ``fn`` (a round function) under network simulation,
    in the reference drivers' order: advance the channel and make the
    masks from the round's ``draws`` (a ``netsim.NetDraws`` on the
    round's device), advance the node faults (``resil.advance``; under
    ``restart_mode="reset"`` the restarting nodes are reset before the
    round), mark the stale nodes, run the round, fold the new state's
    ``mixable_of`` into the gossip buffer, fold the round's conditions
    into the topology policy's EWMAs (``topo.advance``; ``topo`` is its
    ``TopoState`` under the static ``topo_cfg``, ``None`` without an
    adaptive policy), and time the round. ``fault`` is the crash chain's
    ``resil.FaultState`` (``None`` without one). ``frame``: the run's
    telemetry hook (``obs.frame_hook``) or ``None``; it is called after
    the topology advance with the state the round started from (after any
    ``reset`` restart), the new state, the round's info and conditions
    and the folded gossip buffer, and its ``[F]`` row lands in
    ``info["frame"]``. Returns ``(state, chan, gossip, fault, topo, info,
    round_s)``, ``round_s`` a float32 0-d tensor. Both drivers (the loop
    and the engine's captured round) run every netsim round through
    this."""
    n = draws.straggle.shape[0]
    conds, chan = netsim.advance_conditions(net, draws, chan)
    conds, fault, restarted = resil.advance(net, n, conds, fault, draws)
    if restarted is not None:
        state = resil.reset_nodes(n, restarted, fault.init, state)
        mesh = meshctx.current()
        if mesh is not None and mesh.size() > 1:
            # the rank's rows of the model trees; the whole ones (DAC's
            # similarity table) were reset above
            state = resil.reset_nodes(n // mesh.size(),
                                      meshctx.rows(restarted), fault.init,
                                      state)
    conds, published = netsim.apply_async(net, conds, gossip)
    prev = state
    state, info = fn(prev, batches, *topology_args, net=conds,
                     gossip=published, **topo_kw(topo))
    if published is not None:
        gossip = netsim.fold_gossip(net, gossip, conds, mixable_of(state),
                                    stay_rows=meshctx.rows(conds.stale))
    # after the round: round t samples from what was observed up to t - 1
    topo = topo_mod.advance(topo_cfg, net, topo, conds, tiers=draws.tiers)
    if frame is not None:
        info["frame"] = frame(prev, state, info, conds, gossip)
    round_s = round_seconds(net, info, conds, local_steps, tiers=draws.tiers)
    return state, chan, gossip, fault, topo, info, round_s
