"""DEPRL baseline [Xiong et al., AAAI'24]: personalised decentralized
learning with a shared representation. The cores are gossiped over the
static ring; each node's head is trained locally and never sent (the
paper observes it overfits and plateaus, Sec. V-B/V-D)."""
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
class DeprlConfig:
    n_nodes: int
    degree: int = 4
    lr: float = 0.01


def deprl_round(cfg: DeprlConfig, binding: Binding, state: BaselineState,
                batches, drawn=None, net=None, gossip=None, topo=None,
                topo_cfg=None, fault_cfg=None):
    """Mix the cores over the ring, then H local steps on the merged core
    and each node's own head. ``state.params`` holds full models.
    drawn/topo/topo_cfg: an adaptive topology policy's round draw, state
    and config, which replace the ring (see ``dpsgd_round``).
    net/gossip/fault_cfg: as ``el_round``; the published snapshot holds
    full models, of which a stale node exposes the core, and corruption
    mangles only the cores (the heads are never sent)."""
    adaptive = topo_mod.adaptive(topo_cfg)
    if adaptive:
        adj = topo_mod.sample(topo_cfg, topo, drawn.u, drawn.gumbel,
                              cfg.n_nodes, cfg.degree)
    else:
        leaf = next(iter(batches.values()))
        adj = topology.ring(cfg.n_nodes, cfg.degree, device=leaf.device)
    adj = masked_topology(net, adj)
    cores, heads = split.split_params(state.params, binding.head_keys)
    pub_cores = None
    if gossip is not None:
        pub_cores, _ = split.split_params(gossip, binding.head_keys)
    vis = sent_view(net, pub_cores, cores, fault_cfg)
    guard = resil.guard_of(fault_cfg)
    senders = gather_sent(cores if vis is None else vis)
    cores = gossip_mix(topology.mixing_matrix(adj), cores, vis, guard=guard,
                       senders=senders)
    params = local_sgd(binding, split.merge_params(cores, heads), batches,
                       cfg.lr)
    if net is not None:
        params = freeze_inactive(net.active, params, state.params)
    core_bytes = split.tree_size_bytes(tree_map(lambda l: l[0], cores))
    info = comm_info(net, adj, core_bytes, cfg.n_nodes * cfg.degree,
                     actual=adaptive)
    info["quarantined"] = quarantined(guard, vis, senders, adj.device)
    return state._replace(params=params, round=state.round + 1), info
