"""DAC baseline [Zec et al., 2022]: decentralized adaptive clustering.
Each round a node samples its peers with probabilities from the inverse
loss of their models on its own data, and mixes with weights from the
same similarities: a dynamic topology and full-model exchange."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resil
from repro_torch import topo as topo_mod
from repro_torch.tree import tree_map

from .. import meshctx, split, topology
from ..bindings import Binding, gossip_mix, local_sgd
from ..netwire import (comm_info, gather_sent, masked_topology, quarantined,
                       sent_view)
from ..state import BaselineState, freeze_inactive


@dataclasses.dataclass(frozen=True)
class DACConfig:
    n_nodes: int
    degree: int = 4
    lr: float = 0.005
    tau: float = 30.0  # similarity temperature (DAC paper's tau)


def init_dac_extra(n: int) -> dict:
    """Pairwise similarity scores ``[n, n]``, updated every round."""
    return {"sim": torch.zeros((n, n), dtype=torch.float32)}


def sample_neighbors(sim, gumbel, degree: int, tau: float):
    """Gumbel-top-k over the similarity logits ``tau * sim``, self
    excluded: ``[n, degree]`` neighbour ids per node. ``gumbel`` is the
    round's ``[n, n]`` standard Gumbel draw."""
    n = sim.shape[0]
    logits = tau * sim - 1e9 * torch.eye(n, device=sim.device)
    return torch.topk(logits + gumbel, degree, dim=1).indices


def dac_round(cfg: DACConfig, binding: Binding, state: BaselineState,
              batches, drawn, net=None, gossip=None, topo=None,
              topo_cfg=None, fault_cfg=None):
    """batches: ``{"x": [n, H, B, ...], "y": [n, H, B]}``; drawn: the
    round's ``[n, n]`` Gumbel draw (``TorchDraws.gumbel``) or, under an
    adaptive ``topo_cfg``, its ``topo.TopoDraw``.
    net/gossip/fault_cfg: as ``el_round``; a peer delivers its published
    snapshot when stale (perhaps corrupted in transit), an exchange that
    did not deliver keeps the old similarity, and an offline node keeps
    its similarities. Under the guard a peer whose model scores a
    non-finite loss scores 1e9 (as dissimilar as can be) instead of
    poisoning the similarity table.
    topo/topo_cfg: an adaptive policy composes with DAC's own sampler
    through the shared participation-gated pipeline
    (``topo.gumbel_graph``): the link-quality logits add to the
    similarity logits and the fairness floor gates the round, at the
    policy's degree budget; an exchange with or by a non-participant
    keeps the old similarity too."""
    n, r = cfg.n_nodes, cfg.degree
    sim = state.extra["sim"]
    rows = torch.arange(n, device=sim.device)[:, None]
    part = None
    if topo_mod.adaptive(topo_cfg):
        extra = cfg.tau * sim - 1e9 * torch.eye(n, device=sim.device)
        r = topo_mod.budget(topo_cfg, cfg.degree)
        adj, nbr, part = topo_mod.gumbel_graph(
            topo_cfg, topo, drawn.u, drawn.gumbel, n, r, extra_logits=extra)
    else:
        nbr = sample_neighbors(sim, drawn, r, cfg.tau)       # [n, r]
        adj = torch.zeros((n, n), dtype=torch.float32, device=sim.device)
        topology.set_edges(adj, rows, nbr)
        adj = torch.maximum(adj, adj.T)  # symmetrise (push-pull exchange)
    adj = masked_topology(net, adj)

    # what each peer delivers: its published snapshot when stale; under a
    # node mesh every peer's, gathered once
    vis = sent_view(net, gossip, state.params, fault_cfg)
    guard = resil.guard_of(fault_cfg)
    delivered_params = state.params if vis is None else vis
    senders = gather_sent(delivered_params)
    peers_of = delivered_params if senders is None else senders

    # similarity: the inverse loss of each neighbour's model on the node's
    # first local batch, all n * r pairs in one node-batched call. Under a
    # node mesh a rank holds only its nodes' batches: it scores its m * r
    # pairs inside the call at mesh=None's n * r (the other pairs on zero
    # inputs, so the grouped convolutions run mesh=None's kernels), and
    # the scores are gathered: the similarity table is whole on every rank
    with torch.no_grad():
        peers = tree_map(lambda l: l[nbr.reshape(-1)], peers_of)
        mine = {key: meshctx.pad_rows(b[:, 0].repeat_interleave(r, dim=0),
                                      n * r)
                for key, b in batches.items()}
        l_peer = binding.node_losses(peers, mine).reshape(n, r)
    if senders is not None:
        l_peer = meshctx.gather_tree(meshctx.rows(l_peer))
    if guard is not None:
        l_peer = torch.where(torch.isfinite(l_peer), l_peer,
                             torch.full_like(l_peer, 1e9))
    inv_loss = 1.0 / l_peer.float().clamp(min=1e-6)
    if net is not None or part is not None:
        # a lost, offline or non-participating exchange brings no model
        # to score
        inv_loss = torch.where(adj[rows, nbr] > 0, inv_loss, sim[rows, nbr])
    new_sim = sim.clone()
    new_sim[rows, nbr] = inv_loss

    # aggregate with similarity weights, then train locally
    w = topology.weighted_mixing(adj, new_sim.clamp(min=1e-6))
    params = local_sgd(binding, gossip_mix(w, state.params, vis, guard=guard,
                                           senders=senders),
                       batches, cfg.lr)
    if net is not None:
        params = freeze_inactive(net.active, params, state.params)
        new_sim = torch.where(net.active[:, None] > 0, new_sim, sim)
    model_bytes = split.tree_size_bytes(
        tree_map(lambda l: l[0], state.params))
    info = comm_info(net, adj, model_bytes, n * cfg.degree,
                     actual=part is not None)
    info["quarantined"] = quarantined(guard, vis, senders, adj.device)
    return (BaselineState(params=params, round=state.round + 1,
                          extra={"sim": new_sim}), info)
