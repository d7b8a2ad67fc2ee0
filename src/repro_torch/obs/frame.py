"""Per-round device telemetry: the ``MetricsFrame``.

The port of ``repro.obs.frame``. On the segment engine every round
between two evals is a replay of one captured CUDA graph, so what happens
inside a round (cluster settlement, per-tier bytes, staleness, node
faults) is out of the host's sight. A :class:`MetricsFrame` recovers it
without reopening the graph: a fixed set of per-round float32 scalars,
computed on the device inside the round from tensors the round already
has, packed into one ``[F]`` row (:func:`frame_row`, F = 10 plus
``staleness_bins``) that the engine copies into its segment's ``[L, F]``
output buffer beside the cluster ids, and drained with them in the
segment's one copy to the host.

Contract, as the reference's:

* every field is float32 and its shape depends only on the static
  :class:`ObsConfig` (``stale_hist`` ``[staleness_bins]``, every other
  field a scalar); a field that does not apply to a run, or whose gate is
  off, is zeros, never absent;
* :func:`compute_frame` is the one definition both drivers use, at the
  same point of the round (after the gossip fold and the topology
  policy's advance, before ``finalize``), so the engine's frames are the
  loop's bit for bit;
* it only reads: no in-place op on a tensor of the round, and no host
  sync (its gates are static Python), since it runs inside the captured
  graph;
* every :class:`ObsConfig` field forks the ``EngineSpec`` key; the host
  settings on :class:`repro_torch.obs.Obs` never do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Static, device-side telemetry description, an ``EngineSpec`` key
    component: every field changes what the captured round computes, so
    every field forks the key.

    ``norms``/``comm``/``switches``/``faults`` gate their frame fields
    (gated off, a field is zeros); ``staleness_bins`` is the width of the
    gossip-age histogram, ages clipped into its last bin."""
    norms: bool = True           # update/param L2 norms
    comm: bool = True            # delivered edges, inclusion, tier bytes
    switches: bool = True        # FACADE cluster-assignment switches
    staleness_bins: int = 4      # gossip-age histogram width
    faults: bool = True          # crashed/corrupted/quarantined counters

    def __post_init__(self):
        if self.staleness_bins < 1:
            raise ValueError(
                f"staleness_bins must be >= 1, got {self.staleness_bins}")


class MetricsFrame(NamedTuple):
    """One round's telemetry (or, on the host, a stack of rounds with a
    leading axis). float32; scalars except ``stale_hist`` ``[bins]``."""
    update_norm: Any       # global L2 of the round's mixable-state delta
    param_norm: Any        # global L2 of the new mixable state
    cluster_switches: Any  # nodes whose cluster_id changed (0 off-FACADE)
    delivered_edges: Any   # directed edges that carried a message
    inclusion: Any         # fraction of nodes with >= 1 incident edge
    bytes_core: Any        # fresh bytes sent by core-tier nodes
    bytes_edge: Any        # fresh bytes sent by edge-tier nodes
    stale_hist: Any        # [bins] node count per gossip-staleness age
    crashed: Any           # nodes down this round (the crash chain)
    corrupted: Any         # nodes shipping a corrupted payload this round
    quarantined: Any       # senders the robust guard quarantined


FRAME_FIELDS = MetricsFrame._fields


def frame_width(cfg: ObsConfig) -> int:
    """F, the length of a round's packed frame row: 10 scalars and the
    staleness histogram."""
    return len(FRAME_FIELDS) - 1 + cfg.staleness_bins


def _sq_norms(prev_tree, new_tree, zero):
    """(sum (new - prev)^2, sum new^2) in float32 over the float leaves,
    paired by key (a round may rebuild a dict in another key order);
    integer leaves (cluster ids, counters) carry no norm."""
    pairs = []
    tree_map(lambda b, a: pairs.append((a, b)), new_tree, prev_tree)
    usq = psq = zero
    for a, b in pairs:
        if not torch.is_floating_point(b):
            continue
        a32, b32 = a.float(), b.float()
        usq = usq + torch.sum(torch.square(b32 - a32))
        psq = psq + torch.sum(torch.square(b32))
    return usq, psq


def compute_frame(cfg: ObsConfig, n: int, tiers, prev_mix, new_mix,
                  prev_cid, new_cid, info, conds, gossip) -> MetricsFrame:
    """One round's :class:`MetricsFrame`, 0-d (and ``[bins]``) float32
    tensors on ``tiers``' device. Pure observation.

    ``tiers``: the static per-node tier vector ``[n]`` float32 (1.0 =
    edge; all zeros without link classes); ``prev_mix``/``new_mix``: the
    algorithm's mixable trees before the round (after any ``reset``
    restart) and after it; ``prev_cid``/``new_cid``: cluster ids
    (``None`` off-FACADE); ``info``: the round's info dict (``adj_eff``,
    ``payload_bytes``, ``quarantined``); ``conds``: the round's
    ``netsim.RoundConditions`` (``None`` without ``net``); ``gossip``: the
    async-gossip buffer after the round's fold (``None``: every node
    fresh, all of them in age bin 0)."""
    dev = tiers.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    update_norm = param_norm = zero
    if cfg.norms:
        usq, psq = _sq_norms(prev_mix, new_mix, zero)
        update_norm, param_norm = torch.sqrt(usq), torch.sqrt(psq)

    switches = zero
    if cfg.switches and prev_cid is not None and new_cid is not None:
        switches = torch.sum((prev_cid != new_cid).float())

    delivered = inclusion = bytes_core = bytes_edge = zero
    if cfg.comm and "adj_eff" in info:
        adj = info["adj_eff"].float()
        delivered = adj.sum()
        inclusion = torch.mean((adj.sum(1) > 0).float())
        sends = adj
        if conds is not None and conds.stale is not None:
            # a stale sender's neighbours reuse its cached snapshot: no
            # fresh bytes, as comm_info counts them
            sends = adj * (1.0 - conds.stale)[:, None]
        node_bytes = sends.sum(1) * float(info["payload_bytes"])
        bytes_edge = (node_bytes * tiers).sum()
        bytes_core = node_bytes.sum() - bytes_edge

    bins = cfg.staleness_bins
    age_bins = torch.arange(bins, device=dev)
    if gossip is not None:
        age = torch.clamp(gossip.age, 0, bins - 1).long()
        stale_hist = (age[:, None] == age_bins[None, :]).float().sum(0)
    else:
        # every node fresh; built without an indexed store, whose host
        # scalar would be a copy from pageable memory (a host sync)
        stale_hist = (age_bins == 0).float() * float(n)

    crashed = corrupted = quarantined = zero
    if cfg.faults and conds is not None:
        if conds.crashed is not None:
            crashed = torch.sum(conds.crashed.float())
        if conds.corrupt is not None:
            corrupted = torch.sum(conds.corrupt.float())
        if "quarantined" in info:
            quarantined = info["quarantined"].float().reshape(())

    return MetricsFrame(update_norm=update_norm, param_norm=param_norm,
                        cluster_switches=switches,
                        delivered_edges=delivered, inclusion=inclusion,
                        bytes_core=bytes_core, bytes_edge=bytes_edge,
                        stale_hist=stale_hist, crashed=crashed,
                        corrupted=corrupted, quarantined=quarantined)


def frame_row(frame: MetricsFrame) -> torch.Tensor:
    """The frame packed into one ``[F]`` float32 row, in field order."""
    return torch.cat([f.reshape(-1).float() for f in frame])


def frames_of_rows(rows, cfg: ObsConfig) -> MetricsFrame:
    """``[L, F]`` host rows (numpy) -> a :class:`MetricsFrame` of float32
    numpy arrays with leading axis L (``stale_hist`` ``[L, bins]``)."""
    rows = np.asarray(rows, np.float32).reshape(-1, frame_width(cfg))
    bins = cfg.staleness_bins
    at = FRAME_FIELDS.index("stale_hist")
    cols = [rows[:, i] for i in range(at)]
    cols.append(rows[:, at:at + bins])
    cols += [rows[:, at + bins + i]
             for i in range(len(FRAME_FIELDS) - at - 1)]
    return MetricsFrame(*cols)


def frame_hook(cfg: ObsConfig, n: int, tiers, mixable_of, gather=None):
    """``hook(prev, state, info, conds, gossip) -> [F]`` row: the frame of
    one round from the states before and after it, what both drivers call
    (``netwire.net_round(frame=...)`` under ``net``). ``tiers`` is the
    run's tier vector on the device, read when the hook runs (the
    engine's is a static buffer refilled each run). ``gather``: under a
    node mesh, the function that gathers a tree of the rank's rows whole
    (``core.meshctx.gather_tree``, one collective for both states and
    their cluster ids), so the norms and switches count every node in
    ``mesh=None``'s order."""
    def hook(prev, state, info, conds, gossip):
        got = {"prev": mixable_of(prev), "new": mixable_of(state)}
        for key, s in (("prev_cid", prev), ("new_cid", state)):
            cid = getattr(s, "cluster_id", None)
            if cid is not None:
                got[key] = cid
        if gather is not None:
            got = gather(got)
        return frame_row(compute_frame(
            cfg, n, tiers, got["prev"], got["new"], got.get("prev_cid"),
            got.get("new_cid"), info, conds, gossip))
    return hook
