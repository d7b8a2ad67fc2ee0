"""Per-eval fairness telemetry: the ``EvalFrame`` time series.

The port's own copy of ``repro.obs.evalframe`` (numpy only). Every eval
becomes one fairness observation: DP, EO, fair accuracy, per-cluster and
worst-cluster accuracy, and cluster-assignment churn since the previous
eval. The frame is pure host bookkeeping over the arrays the evaluator
already brought back, and the run's final ``dp``/``eo``/``fair_acc`` are
read off its last entry.

Under network simulation with link classes (``net.classes``, the
``core-edge`` and ``edge-v2`` presets) the per-node accuracy splits by
tier (:func:`tiers_of`): ``acc_core``, ``acc_edge`` and their gap. Without
tiers every node counts as a core-tier node.

:func:`eval_table` stacks a run's frames into columns and
:func:`frame_record` is a frame's ``type: "eval"`` JSONL record, as the
reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch import netsim
from repro_torch.fairness import (demographic_parity, equalized_odds,
                                  fair_accuracy)


class EvalFrame(NamedTuple):
    """One eval's fairness observation, in plain Python scalars/tuples."""
    round: int                  # 1-based eval round
    mean_acc: float             # node-weighted mean accuracy
    fair_acc: float             # paper Eq. 5 (lambda = 2/3)
    dp: float                   # demographic parity gap at this eval
    eo: float                   # equalized odds gap at this eval
    worst_cluster_acc: float    # min over the clusters that exist
    acc: tuple                  # per-cluster accuracy, ``cluster_ids`` order
    cluster_ids: tuple          # which cluster each ``acc`` entry is
    acc_core: float             # mean per-node accuracy, core-tier nodes
    acc_edge: float             # mean per-node accuracy, edge-tier nodes
    tier_gap: float             # acc_core - acc_edge
    cluster_churn: float        # nodes whose cluster assignment changed
    #                             since the previous eval (0 at the first
    #                             eval and off-FACADE)


EVAL_FIELDS = EvalFrame._fields

# the scalar fields (all but the ragged per-cluster vectors): what
# eval_table stacks into aligned numpy columns
EVAL_SCALAR_FIELDS = tuple(f for f in EVAL_FIELDS
                           if f not in ("acc", "cluster_ids"))


def tiers_of(net, n: int, source) -> np.ndarray:
    """The static per-node tier vector ``[n]`` float32 (1.0 = edge) of
    ``net``'s link classes, from the run's draws source (its
    ``net_uniform``); all-core when the run has no tiered link classes."""
    if net is not None and net.classes is not None:
        return netsim.NetSchedule(net, n, source).tiers.numpy().astype(
            np.float32)
    return np.zeros((n,), np.float32)


def compute_eval_frame(rnd: int, accs, cluster_ids, preds_c, labels_c,
                       node_acc, n_classes: int, *, mean_acc: float,
                       tiers=None, prev_cid=None, cid=None) -> EvalFrame:
    """Build one eval's :class:`EvalFrame` from what the evaluator returned
    (per-cluster accuracies, first-node predictions and labels per cluster,
    per-node accuracy). ``mean_acc`` is passed through, never recomputed;
    ``tiers`` is the static per-node tier vector (1.0 = edge,
    :func:`tiers_of`) or ``None``; ``prev_cid``/``cid`` are the cluster ids
    at the previous and current eval (``None`` off-FACADE and at the first
    eval)."""
    accs = [float(a) for a in accs]
    acc_core = acc_edge = tier_gap = 0.0
    if node_acc is not None:
        node_acc = np.asarray(node_acc, np.float64)
        if tiers is not None:
            edge = np.asarray(tiers, np.float64) > 0.5
            core_acc, edge_acc = node_acc[~edge], node_acc[edge]
        else:
            core_acc, edge_acc = node_acc, node_acc[:0]
        acc_core = float(core_acc.mean()) if core_acc.size else 0.0
        acc_edge = float(edge_acc.mean()) if edge_acc.size else 0.0
        if core_acc.size and edge_acc.size:
            tier_gap = acc_core - acc_edge
    churn = 0.0
    if prev_cid is not None and cid is not None:
        churn = float(np.sum(np.asarray(prev_cid) != np.asarray(cid)))
    return EvalFrame(
        round=int(rnd),
        mean_acc=float(mean_acc),
        fair_acc=float(fair_accuracy(accs)),
        dp=float(demographic_parity(preds_c, n_classes)),
        eo=float(equalized_odds(preds_c, labels_c, n_classes)),
        worst_cluster_acc=float(min(accs)) if accs else 0.0,
        acc=tuple(accs),
        cluster_ids=tuple(int(c) for c in cluster_ids),
        acc_core=acc_core, acc_edge=acc_edge, tier_gap=tier_gap,
        cluster_churn=churn)


def eval_table(frames) -> dict:
    """Stack a list of :class:`EvalFrame` into aligned columns: numpy
    arrays for every scalar field (``round`` int64, the rest float64) and
    ``acc``/``cluster_ids`` as lists of tuples (ragged across runs with
    different cluster counts)."""
    out = {}
    for name in EVAL_SCALAR_FIELDS:
        dtype = np.int64 if name == "round" else np.float64
        out[name] = np.asarray([getattr(f, name) for f in frames], dtype)
    out["acc"] = [f.acc for f in frames]
    out["cluster_ids"] = [f.cluster_ids for f in frames]
    return out


def frame_record(frame: EvalFrame) -> dict:
    """The ``type: "eval"`` JSONL record of one frame."""
    rec = {"type": "eval"}
    for name, v in zip(EVAL_FIELDS, frame):
        rec[name] = list(v) if isinstance(v, tuple) else v
    return rec
