"""Epidemic Learning (EL) baseline [NeurIPS'23, de Vos et al.]:
D-PSGD over a fresh random r-regular topology each round. This is the
paper's primary baseline and the communication-cost reference point."""
from __future__ import annotations

import dataclasses

from repro_torch import resil
from repro_torch import topo as topo_mod
from repro_torch.tree import tree_map

from .. import split, topology
from ..bindings import Binding, gossip_mix, local_sgd
from ..netwire import (comm_info, gather_sent, masked_topology, quarantined,
                       sent_view)
from ..state import BaselineState, freeze_inactive


@dataclasses.dataclass(frozen=True)
class ELConfig:
    n_nodes: int
    degree: int = 4
    lr: float = 0.05


def el_round(cfg: ELConfig, binding: Binding, state: BaselineState, batches,
             drawn, net=None, gossip=None, topo=None, topo_cfg=None,
             fault_cfg=None):
    """batches: ``{"x": [n, H, B, ...], "y": [n, H, B]}``; drawn: the
    round's topology permutations (:func:`topology.random_regular`) or,
    under an adaptive ``topo_cfg``, its ``topo.TopoDraw``; topo: the
    policy's ``TopoState`` (see ``facade_round``); net:
    the round's ``netsim.RoundConditions`` (see ``facade_round``); gossip:
    the async-gossip published params; fault_cfg: the run's
    ``resil.FaultConfig`` (payload corruption and the mix's guard, see
    ``facade_round``)."""
    adaptive = topo_mod.adaptive(topo_cfg)
    if adaptive:
        adj = topo_mod.sample(topo_cfg, topo, drawn.u, drawn.gumbel,
                              cfg.n_nodes, cfg.degree)
    else:
        adj = topology.random_regular(drawn, cfg.n_nodes, cfg.degree)
    adj = masked_topology(net, adj)
    vis = sent_view(net, gossip, state.params, fault_cfg)
    guard = resil.guard_of(fault_cfg)
    senders = gather_sent(state.params if vis is None else vis)
    params = gossip_mix(topology.mixing_matrix(adj), state.params, vis,
                        guard=guard, senders=senders)
    params = local_sgd(binding, params, batches, cfg.lr)
    if net is not None:
        params = freeze_inactive(net.active, params, state.params)
    model_bytes = split.tree_size_bytes(
        tree_map(lambda l: l[0], state.params))
    info = comm_info(net, adj, model_bytes, cfg.n_nodes * cfg.degree,
                     actual=adaptive)
    info["quarantined"] = quarantined(guard, vis, senders, adj.device)
    return BaselineState(params=params, round=state.round + 1), info
