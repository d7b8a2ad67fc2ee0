"""The port's own copies of the reference's host-side metrics: the comm
log, DP/EO/fair accuracy and the per-eval fairness frame give the
reference's values exactly on the same inputs."""
from __future__ import annotations

import numpy as np
import pytest

from repro.comm import CommLog as RefCommLog
from repro.fairness import metrics as ref_metrics
from repro.obs.evalframe import compute_eval_frame as ref_eval_frame
from repro_torch.comm import CommLog
from repro_torch.fairness import metrics
from repro_torch.obs import compute_eval_frame

SCHEDULE = [(1, 100.0, None), (2, 100.0, 0.4), (3, 100.0, None),
            (4, 100.0, 0.7), (5, 100.0, None), (6, 100.0, 0.65)]


def test_comm_log_matches_the_reference():
    ours, ref = CommLog(), RefCommLog()
    for rnd, b, acc in SCHEDULE:
        ours.record(rnd, b, acc)
        ref.record(rnd, b, acc)
    for field in ("rounds", "bytes", "acc", "evaled"):
        assert getattr(ours, field) == getattr(ref, field)
    for target in (0.0, 0.4, 0.5, 0.7, 0.9):
        assert ours.bytes_to_target(target) == ref.bytes_to_target(target)
    assert ours.total_gb == ref.total_gb
    assert CommLog().bytes_to_target(0.0) is None and CommLog().total_gb == 0


def _preds(seed, k, n_classes=5, m=40):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, n_classes, m) for _ in range(k)],
            [rng.integers(0, n_classes, m) for _ in range(k)])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fairness_metrics_match_the_reference(k):
    preds, labels = _preds(k, k)
    accs = list(np.random.default_rng(k).random(k))
    assert metrics.demographic_parity(preds, 5) == \
        ref_metrics.demographic_parity(preds, 5)
    assert metrics.equalized_odds(preds, labels, 5) == \
        ref_metrics.equalized_odds(preds, labels, 5)
    assert metrics.fair_accuracy(accs) == ref_metrics.fair_accuracy(accs)


@pytest.mark.parametrize("with_cid", [False, True])
def test_eval_frame_matches_the_reference_without_tiers(with_cid):
    preds, labels = _preds(7, 2)
    node_acc = np.random.default_rng(3).random(8)
    cids = dict(prev_cid=np.array([0, 1] * 4), cid=np.array([0] * 8)) \
        if with_cid else {}
    args = (6, [0.8, 0.55], (0, 1), preds, labels, node_acc, 5)
    assert compute_eval_frame(*args, mean_acc=0.7, **cids) == \
        ref_eval_frame(*args, mean_acc=0.7, **cids)
