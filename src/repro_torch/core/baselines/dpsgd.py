"""D-PSGD baseline [Lian et al., NeurIPS'17]: decentralized SGD over a
static topology (paper Alg. 1 / Appendix B), here the reference's static
ring. Each round trains locally first, then mixes."""
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
class DpsgdConfig:
    n_nodes: int
    degree: int = 4
    lr: float = 0.05


def dpsgd_round(cfg: DpsgdConfig, binding: Binding, state: BaselineState,
                batches, drawn=None, net=None, gossip=None, topo=None,
                topo_cfg=None, fault_cfg=None):
    """batches: ``{"x": [n, H, B, ...], "y": [n, H, B]}``. The ring is
    static, so the round draws nothing, unless an adaptive ``topo_cfg``
    samples the graph: ``drawn`` is then the round's ``topo.TopoDraw``,
    from the policy's own seeded round stream (``topo.static_draw``), and
    ``topo`` its ``TopoState``. net/gossip/fault_cfg: as
    ``el_round``; a stale neighbour contributes its last published model
    instead of this round's trained one, a corrupting one a mangled
    copy of its trained one."""
    adaptive = topo_mod.adaptive(topo_cfg)
    if adaptive:
        adj = topo_mod.sample(topo_cfg, topo, drawn.u, drawn.gumbel,
                              cfg.n_nodes, cfg.degree)
    else:
        leaf = next(iter(batches.values()))
        adj = topology.ring(cfg.n_nodes, cfg.degree, device=leaf.device)
    adj = masked_topology(net, adj)
    params = local_sgd(binding, state.params, batches, cfg.lr)
    vis = sent_view(net, gossip, params, fault_cfg)
    guard = resil.guard_of(fault_cfg)
    senders = gather_sent(params if vis is None else vis)
    params = gossip_mix(topology.mixing_matrix(adj), params, vis,
                        guard=guard, senders=senders)
    if net is not None:
        params = freeze_inactive(net.active, params, state.params)
    model_bytes = split.tree_size_bytes(
        tree_map(lambda l: l[0], state.params))
    info = comm_info(net, adj, model_bytes, cfg.n_nodes * cfg.degree,
                     actual=adaptive)
    info["quarantined"] = quarantined(guard, vis, senders, adj.device)
    return state._replace(params=params, round=state.round + 1), info
