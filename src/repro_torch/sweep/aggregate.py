"""Cross-seed aggregation: per-cell mean/std tables from ``RunResult``s.

The port's copy of ``repro.sweep.aggregate`` (numpy only), unchanged.

The paper's figures report per-(algorithm, imbalance, dataset) cells
averaged over seeds — accuracy / fair-accuracy trajectories, final
fairness gaps (DP/EO), and bytes- / seconds-to-target. ``aggregate_cell``
turns one cell's list of per-seed
:class:`repro_torch.core.runner.RunResult` into exactly those tables,
JSON-ready (plain floats/lists only).

Trajectories are aligned on eval ROUND (not list index): ``target_acc``
early exit can truncate some seeds, so every trajectory row carries ``n``,
the number of seeds that actually reached that eval round.
"""
from __future__ import annotations

import numpy as np


def _ms(vals) -> dict:
    arr = np.asarray(list(vals), np.float64)
    return {"mean": float(arr.mean()), "std": float(arr.std())}


def aggregate_cell(results, targets=()) -> dict:
    """Aggregate one cell's per-seed results.

    ``targets``: accuracies for the bytes/seconds-to-target table. A seed
    that never crossed a target contributes to ``reached_frac`` only —
    averaging its ``None`` away would understate the true cost.
    """
    if not results:
        raise ValueError("aggregate_cell needs at least one RunResult")
    n_seeds = len(results)

    rounds = sorted({r for res in results for r, _ in res.fair_acc})
    fair = {r: [] for r in rounds}
    accs = {r: [] for r in rounds}
    for res in results:
        for r, fa in res.fair_acc:
            fair[r].append(fa)
        for r, a in res.acc_per_cluster:
            accs[r].append(a)
    trajectory = []
    for r in rounds:
        fa = np.asarray(fair[r], np.float64)
        pc = np.asarray(accs[r], np.float64)          # [seeds, k]
        trajectory.append({
            "round": r, "n": int(fa.size),
            "fair_acc_mean": float(fa.mean()),
            "fair_acc_std": float(fa.std()),
            "acc_mean": pc.mean(0).tolist(),
            "acc_std": pc.std(0).tolist()})

    # per-eval fairness trajectory: mean/std of each EvalFrame scalar
    # aligned on eval round (same target_acc-truncation semantics as the
    # accuracy trajectory above). getattr-defensive: results loaded from
    # older summaries/pickles may predate RunResult.eval_frames.
    fair_fields = ("dp", "eo", "worst_cluster_acc", "cluster_churn")
    by_round: dict = {}
    for res in results:
        for f in getattr(res, "eval_frames", None) or ():
            slot = by_round.setdefault(int(f.round),
                                       {k: [] for k in fair_fields})
            for k in fair_fields:
                slot[k].append(getattr(f, k))
    fairness_trajectory = []
    for r in sorted(by_round):
        row = {"round": r, "n": len(by_round[r][fair_fields[0]])}
        for k in fair_fields:
            row[f"{k}_mean"] = float(np.mean(by_round[r][k]))
            row[f"{k}_std"] = float(np.std(by_round[r][k]))
        fairness_trajectory.append(row)

    out = {
        "n_seeds": n_seeds,
        "eval_rounds": rounds,
        "trajectory": trajectory,
        "fairness_trajectory": fairness_trajectory,
        "best_fair_acc": _ms(res.best_fair_acc() for res in results),
        "final_fair_acc": _ms(
            (res.fair_acc[-1][1] if res.fair_acc else 0.0)
            for res in results),
        "dp": _ms(res.dp for res in results),
        "eo": _ms(res.eo for res in results),
        "stop_round": _ms(
            (res.comm.rounds[-1] if res.comm.rounds else 0)
            for res in results),
        "total_bytes": _ms(
            (res.comm.bytes[-1] if res.comm.bytes else 0.0)
            for res in results),
        "sim_seconds": _ms(
            (res.comm.seconds[-1] if res.comm.seconds else 0.0)
            for res in results),
        "to_target": {},
    }
    finals = np.asarray([res.final_acc for res in results], np.float64)
    out["final_acc_mean"] = finals.mean(0).tolist()
    out["final_acc_std"] = finals.std(0).tolist()

    for t in targets:
        bs = [res.comm.bytes_to_target(t) for res in results]
        ss = [res.comm.seconds_to_target(t) for res in results]
        reached_b = [b for b in bs if b is not None]
        entry = {"reached_frac": len(reached_b) / n_seeds}
        if reached_b:
            entry["bytes"] = _ms(reached_b)
            entry["seconds"] = _ms(s for s in ss if s is not None)
        else:
            # explicit CommLog sentinel: no seed ever crossed this target
            # — consumers key on `is None`, not on a missing key
            entry["bytes"] = None
            entry["seconds"] = None
        out["to_target"][f"{t:g}"] = entry
    return out
