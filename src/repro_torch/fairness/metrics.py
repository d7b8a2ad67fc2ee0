"""Fairness metrics from the paper (Sec. II-B, V-C); a numpy copy of
``repro.fairness.metrics``.

  * demographic parity (Eq. 1):  sum_y |P[Yhat=y|S=0] - P[Yhat=y|S=1]|
  * equalized odds   (Eq. 2):    sum_y |P[Yhat=y|Y=y,S=1] - P[Yhat=y|Y=y,S=0]|
  * fair accuracy    (Eq. 5):    lam * mean_j Acc_j + (1-lam) * (1 - (max-min))

For k > 2 clusters, DP/EO report the MAXIMUM over cluster pairs (the
worst-case group gap; reduces to the paper's definition at k=2).
"""
from __future__ import annotations

import itertools

import numpy as np


def _pred_dist(preds: np.ndarray, n_classes: int) -> np.ndarray:
    return np.bincount(preds, minlength=n_classes) / max(len(preds), 1)


def demographic_parity(preds_per_cluster, n_classes: int) -> float:
    """preds_per_cluster: list (per cluster) of int prediction arrays."""
    dists = [_pred_dist(p, n_classes) for p in preds_per_cluster]
    if len(dists) < 2:
        return 0.0
    return float(max(np.abs(a - b).sum()
                     for a, b in itertools.combinations(dists, 2)))


def _tpr(preds: np.ndarray, labels: np.ndarray, n_classes: int) -> np.ndarray:
    tpr = np.zeros(n_classes)
    for y in range(n_classes):
        m = labels == y
        tpr[y] = (preds[m] == y).mean() if m.any() else 0.0
    return tpr


def equalized_odds(preds_per_cluster, labels_per_cluster,
                   n_classes: int) -> float:
    rates = [_tpr(p, l, n_classes)
             for p, l in zip(preds_per_cluster, labels_per_cluster)]
    if len(rates) < 2:
        return 0.0
    return float(max(np.abs(a - b).sum()
                     for a, b in itertools.combinations(rates, 2)))


def fair_accuracy(acc_per_cluster, lam: float = 2.0 / 3.0) -> float:
    """Eq. 5 with the paper's lambda = 2/3. Accuracies normalized in [0,1]."""
    accs = np.asarray(acc_per_cluster, np.float64)
    penalty = 1.0 - (accs.max() - accs.min())
    return float(lam * accs.mean() + (1.0 - lam) * penalty)
