"""Latency/bandwidth cost model, bytes + topology -> simulated seconds, the
port of ``repro.netsim.timing`` (float32 on the run's device).

A synchronous gossip round finishes when the slowest active node has both
(a) run its H local steps and (b) completed its slowest link exchange.
Stragglers multiply their compute and any link touching them. The result
feeds ``CommLog``'s time axis ("simulated hours to target accuracy", the
companion of the paper's Fig. 7 "GB to target accuracy").

With link classes (``cfg.classes``) the per-link base time comes from
``[n, n]`` latency/bandwidth matrices (:func:`link_matrices`): a link runs
at its worse endpoint. Under asynchronous gossip stale nodes do not gate
the round; the caller zeroes their entry in ``active``
(``netwire.round_seconds``).
"""
from __future__ import annotations

import torch


def link_seconds(cfg, payload_bytes):
    """One message's transfer time on a clean link (latency +
    serialisation). ``payload_bytes`` a number or a float32 tensor."""
    return cfg.latency_s + 8.0 * payload_bytes / cfg.bandwidth_bps


def link_matrices(cfg, tiers):
    """Per-link ``(latency [n, n], bandwidth [n, n])`` float32 from the
    node tiers (``[n]``, 1 = edge, ``conditions.node_tiers``): symmetric,
    each link at its worse endpoint's class. Requires ``cfg.classes``."""
    cl = cfg.classes
    lat = torch.where(tiers > 0, cl.edge_latency_s, cl.core_latency_s)
    bw = torch.where(tiers > 0, cl.edge_bandwidth_bps, cl.core_bandwidth_bps)
    return (torch.maximum(lat[:, None], lat[None, :]),
            torch.minimum(bw[:, None], bw[None, :]))


def round_time(cfg, adj_eff, payload_bytes, active, straggler,
               local_steps: int, tiers=None):
    """Simulated wall-clock seconds of one synchronous round, a float32
    0-d tensor.

    adj_eff  [n, n]: effective (post-churn, post-drop) adjacency;
    active    [n]:   {0,1} gate mask (offline and, under async gossip,
                     stale nodes do not gate the round);
    straggler [n]:   {0,1} mask from this round's conditions;
    tiers     [n]:   the node tiers, needed iff ``cfg.classes`` is set.
    An empty round (everyone churned out) costs 0 seconds.
    """
    slow = 1.0 + (cfg.straggler_slowdown - 1.0) * straggler        # [n]
    if cfg.classes is None:
        base_link = link_seconds(cfg, payload_bytes)               # scalar
    else:
        lat, bw = link_matrices(cfg, tiers.to(adj_eff.device))
        base_link = lat + 8.0 * payload_bytes / bw                 # [n, n]
    # link (i, j) runs at the slower endpoint's pace; links run in parallel
    pair_slow = torch.maximum(slow[:, None], slow[None, :])        # [n, n]
    comm = (adj_eff * pair_slow * base_link).amax(dim=1)           # [n]
    compute = local_steps * cfg.compute_s_per_step * slow          # [n]
    return ((compute + comm) * active).amax().clamp(min=0.0)
