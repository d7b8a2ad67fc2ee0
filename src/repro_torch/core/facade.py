"""The FACADE algorithm (paper Sec. III-D), on the ideal medium or under
simulated network conditions (``net=``, :mod:`repro_torch.netsim`).

One call to ``facade_round`` executes, for all nodes at once:

    1. the round's r-regular topology, from the given permutations, or
       under an adaptive topology policy its Gumbel-top-k graph (step 1)
    2. core aggregation (Eq. 3) + cluster-wise head aggregation (Eq. 4)
    3. cluster identification: argmin_j loss(core ∘ head_j)  (step 2c),
       one call of the head-select kernel for all n nodes
    4. H local SGD steps on (core, selected head)            (step 2d)
    5. write the trained head into the selected slot; report the cluster ID

Node states are stacked (leading ``n`` axis); gossip is an einsum with the
round's mixing matrix.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import localmap, resil
from repro_torch import topo as topo_mod
from repro_torch.kernels.head_select import head_losses
from repro_torch.tree import tree_leaves, tree_map

from . import meshctx, split, topology
from .bindings import (Binding, gossip_mix, local_sgd, node_head_matmul,
                       node_matmul)
from .netwire import comm_info, masked_topology, sent_view
from .state import FacadeState, freeze_inactive


@dataclasses.dataclass(frozen=True)
class FacadeConfig:
    n_nodes: int
    k: int                    # number of cluster heads (paper hyperparam)
    degree: int = 4           # topology degree r (paper: 4)
    lr: float = 0.01


def _aggregate_heads(adj, cluster_id, heads, k: int, sent_heads=None,
                     guard=None, gathered=None):
    """Eq. 4: for each node i and cluster j, average the heads sent by
    neighbors claiming cluster j together with i's own stored head j.
    heads [n, k, ...]; node j' sends its head ``sent_heads[j', cid[j']]``.
    ``cluster_id`` and ``sent_heads`` (default ``heads``) are what each
    node publishes this round (under async gossip a stale node publishes
    its old snapshot, under payload corruption perhaps a mangled one);
    ``heads`` is always the receiver's own bank.

    ``guard`` (:func:`repro_torch.resil.guard_of`): the head-bank
    counterpart of ``gossip_mix``'s guard. A sender whose published head
    is non-finite is quarantined (out of both the sum and the count), and
    finite senders are norm-clipped against the receiver's own per-slot
    RMS head norm. ``None`` is the fault-free arithmetic bit for bit.

    ``gathered`` (a node mesh, :func:`_gather_sent`): every sender's
    published head and cluster id, ``{"head", "cid"}`` ``[n, ...]``;
    ``adj`` is whole and ``heads`` holds the rank's rows, whose rows of
    the result this returns."""
    if gathered is None:
        n = adj.shape[0]
        rows = torch.arange(n, device=adj.device)
        sent = tree_map(lambda h: h[rows, cluster_id],
                        heads if sent_heads is None else sent_heads)
        cid = cluster_id
    else:
        sent, cid = gathered["head"], gathered["cid"]
        adj = meshctx.rows(adj)                              # [m, n]
    onehot = F.one_hot(cid, k).to(torch.float32)             # [n, k]
    adj_w = adj
    if guard is not None:
        finite = resil.node_finite(sent)                     # [n]
        snorm = torch.where(finite > 0, resil.node_norm(sent),
                            torch.ones_like(finite))
        own = meshctx.rows_of(resil.node_norm(tree_map(      # per-slot RMS
            lambda h: meshctx.pad_rows(h, adj.shape[1]), heads)), adj
        ) / math.sqrt(float(k))
        clip = torch.clamp(
            guard.clip * own.clamp(min=1e-12)[:, None]
            / snorm.clamp(min=1e-12)[None, :], max=1.0)      # [n, n]
        # quarantined senders leave both the weighted sum and the count;
        # their (perhaps NaN) head leaves are zeroed before the product
        adj = adj * finite[None, :]
        adj_w = adj * clip
        sent = resil_tree_zero(sent, finite)
    denom = 1.0 + node_matmul(adj, onehot)                   # [n, k]

    def agg(h_all, h_sent):
        recv = node_head_matmul(adj_w.to(h_sent.dtype),
                                onehot.to(h_sent.dtype), h_sent)
        d = denom.reshape(denom.shape + (1,) * (h_all.dim() - 2))
        return ((h_all + recv) / d.to(h_all.dtype)).to(h_all.dtype)

    return tree_map(agg, heads, sent)


def _gather_sent(cores, heads, cluster_id, finite_of=None):
    """Under a node mesh, what every node sends this round, gathered whole
    in one collective: its core ``cores``, the head it publishes (slot
    ``cluster_id`` of ``heads``), its cluster id and, with ``finite_of``
    (the guard's sent tree), whether all of it is finite (what
    ``resil.quarantined_count`` counts). ``None`` without a mesh."""
    if meshctx.current() is None:
        return None
    bundle = {"cores": cores, "head": split.select_head(heads, cluster_id),
              "cid": cluster_id}
    if finite_of is not None:
        bundle["finite"] = resil.node_finite(finite_of)
    return meshctx.gather_tree(bundle)


def resil_tree_zero(tree, keep):
    """Zero the float leaves of nodes with ``keep == 0`` along the leading
    axis (quarantine hygiene: 0 weight times NaN is still NaN in a
    product)."""
    def z(leaf):
        if not leaf.is_floating_point():
            return leaf
        m = keep.reshape((keep.shape[0],) + (1,) * (leaf.dim() - 1))
        return torch.where(m > 0, leaf, torch.zeros_like(leaf))

    return tree_map(z, tree)


def _select_heads(binding: Binding, cores, heads, batch, n: int):
    """losses [n, k] over shared core features (paper III-E): the core runs
    once per node on ``batch``, then one head-select call scores all k
    heads of all n nodes (under a node mesh, ``n`` is the rank's count)."""
    with torch.no_grad():
        feats = binding.features(cores, batch)
        f, w, labels = binding.select_operands(feats, heads, batch)
        return head_losses(f, w, labels).reshape(n, -1)


def payload_bytes(state: FacadeState) -> int:
    """What one node pushes to one neighbor: its core, one head and its
    4-byte cluster id."""
    core = split.tree_size_bytes(tree_map(lambda l: l[0], state.cores))
    head = split.tree_size_bytes(tree_map(lambda l: l[0, 0], state.heads))
    return core + head + 4


def facade_round(fcfg: FacadeConfig, binding: Binding, state: FacadeState,
                 batches, drawn, warmup: bool = False, net=None,
                 gossip=None, topo=None, topo_cfg=None, fault_cfg=None):
    """One synchronous FACADE round for all nodes.

    batches: per node and local step, ``{"x": [n, H, B, ...], "y": [n, H,
    B]}`` for a CNN or ``{"tokens", "labels", "mask"}`` of ``[n, H, B, S]``
    for a language model; drawn: the round's topology draw, the
    permutations of :func:`topology.random_regular`, or under an adaptive
    ``topo_cfg`` a :class:`repro_torch.topo.TopoDraw`. ``warmup`` (App.
    F) trains head 0 everywhere and copies it to every slot.
    net: the round's ``netsim.RoundConditions``, or ``None`` for the ideal
    medium. With conditions, the drawn topology is filtered through
    :func:`topology.effective_adjacency`, offline nodes neither mix nor
    train (their state is frozen), and the bytes count the directed edges
    that carried a message. gossip: the async-gossip published snapshot
    (``cores`` / ``heads`` / ``cluster_id``), which stale nodes
    (``net.stale``) expose to their neighbours instead of this round's
    state.
    topo/topo_cfg: the adaptive topology policy's ``TopoState`` and its
    static :class:`repro_torch.topo.TopoConfig` (or ``None``): an adaptive
    policy samples the round's graph from its link scores instead of the
    r-regular draw, and the bytes count that graph's edges on the ideal
    medium too.
    fault_cfg: the run's static :class:`repro_torch.resil.FaultConfig`
    (or ``None``): payload corruption mangles what a flagged node
    delivers (``netwire.sent_view``) and, when robust, the guard
    quarantines and clips poisoned senders in both the core mix and the
    head aggregation.
    Returns (new_state, info with losses, selection, the senders the guard
    quarantined, the round's bytes and what ``netwire.round_seconds``
    needs).
    """
    n, k = fcfg.n_nodes, fcfg.k
    adaptive = topo_mod.adaptive(topo_cfg)
    if adaptive:
        adj = topo_mod.sample(topo_cfg, topo, drawn.u, drawn.gumbel, n,
                              fcfg.degree)
    else:
        adj = topology.random_regular(drawn, n, fcfg.degree)
    adj = masked_topology(net, adj)
    w = topology.mixing_matrix(adj)

    # --- what each node's neighbours receive: its fresh state, unless it
    # --- stays stale under async gossip or ships a corrupted payload ---
    sent = sent_view(net, gossip, {"cores": state.cores,
                                   "heads": state.heads,
                                   "cluster_id": state.cluster_id},
                     fault_cfg)
    if sent is None:
        vis_cores, sent_heads, sent_cid = None, None, state.cluster_id
    else:
        vis_cores, sent_heads = sent["cores"], sent["heads"]
        sent_cid = sent["cluster_id"]

    # --- aggregation (steps 2a/2b); under a node mesh the senders are
    # --- gathered once, and this rank mixes its m rows ---
    guard = resil.guard_of(fault_cfg)
    whole = _gather_sent(state.cores if vis_cores is None else vis_cores,
                         state.heads if sent_heads is None else sent_heads,
                         sent_cid, None if guard is None else sent)
    cores = gossip_mix(w, state.cores, vis_cores, guard=guard,
                       senders=None if whole is None else whole["cores"])
    heads = _aggregate_heads(adj, sent_cid, state.heads, k,
                             sent_heads=sent_heads, guard=guard,
                             gathered=whole)

    # --- cluster identification (step 2c) on the first local batch ---
    m = state.cluster_id.shape[0]          # n, or the rank's n / P
    first = {key: b[:, 0] for key, b in batches.items()}
    losses = localmap.per_node(                              # [m, k]
        lambda c, h, b: _select_heads(binding, c, h, b,
                                      tree_leaves(c)[0].shape[0]),
        cores, heads, first)
    if warmup:
        new_cid = torch.zeros((m,), dtype=torch.long, device=adj.device)
    else:
        new_cid = torch.argmin(losses, dim=1)

    # --- local training (step 2d) ---
    params = localmap.per_node(
        lambda c, h, cid, b: local_sgd(
            binding, split.merge_params(c, split.select_head(h, cid)), b,
            fcfg.lr), cores, heads, new_cid, batches)
    new_cores, new_head = split.split_params(params, binding.head_keys)
    if warmup:  # broadcast the trained head to every slot
        new_heads = tree_map(
            lambda h: h.unsqueeze(1).expand((m, k) + h.shape[1:]).clone(),
            new_head)
    else:
        new_heads = localmap.per_node(split.set_head, heads, new_cid,
                                      new_head)
    if net is not None:
        new_cid = torch.where(meshctx.rows(net.active) > 0, new_cid,
                              state.cluster_id)
        new_cores = freeze_inactive(net.active, new_cores, state.cores)
        new_heads = freeze_inactive(net.active, new_heads, state.heads)

    # --- communication accounting: each node pushes (core, head, cid) ---
    new_state = FacadeState(cores=new_cores, heads=new_heads,
                            cluster_id=new_cid, round=state.round + 1)
    return new_state, {"selection_losses": losses, "cluster_id": new_cid,
                       "quarantined": _quarantined(guard, sent, whole,
                                                   adj.device),
                       **comm_info(net, adj, payload_bytes(state),
                                   n * fcfg.degree, actual=adaptive)}


def _quarantined(guard, sent, whole, device):
    """The senders the guard quarantined this round, counted over every
    sender: from the gathered finiteness under a node mesh."""
    if guard is None or sent is None or whole is None:
        return resil.quarantined_count(guard, sent, device=device)
    return (1.0 - whole["finite"]).sum()


def final_allreduce(fcfg: FacadeConfig, state: FacadeState) -> FacadeState:
    """Paper Sec. V-A: a final all-reduce where every node shares its model
    with everyone and aggregates cluster-wise (under a node mesh, the
    senders gathered once)."""
    n, k = fcfg.n_nodes, fcfg.k
    adj = topology.fully_connected(n, device=state.cluster_id.device)
    w = topology.mixing_matrix(adj)
    whole = _gather_sent(state.cores, state.heads, state.cluster_id)
    return state._replace(
        cores=gossip_mix(w, state.cores,
                         senders=None if whole is None else whole["cores"]),
        heads=_aggregate_heads(adj, state.cluster_id, state.heads, k,
                               gathered=whole))


def node_models(state: FacadeState) -> dict:
    """Merged per-node deployable models, stacked [n, ...]."""
    return split.merge_params(state.cores,
                              split.select_head(state.heads,
                                                state.cluster_id))
