"""Run reports: a manifest and its JSONL trace rendered to markdown/JSON.

The port of ``repro.obs.report``, rendering the same text. The manifest
says what ran (fingerprint, settings, timing rollup, health verdict);
the JSONL says how it went (per-eval ``EvalFrame`` records, per-round
metrics, health events). The report joins them: the fairness
trajectory, the cluster-settlement round, the health verdict with each
issue's round range, and the timing and cache rollup.

CLI (a single-run manifest or a ``run_sweep`` JSON)::

    python -m repro_torch.obs.report build/obs/manifest_facade-seed0.json
    python -m repro_torch.obs.report build/sweep.json --out report.md
    python -m repro_torch.obs.report manifest.json --jsonl trace.jsonl --json

A run's JSONL comes from ``manifest.settings["jsonl"]`` (recorded by
``run_experiment``) unless ``--jsonl`` names another; a missing trace
gives a manifest-only report (no trajectory table) rather than an error.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from .sink import RunManifest, read_jsonl

# the trajectory columns a report tabulates, in display order
_TRAJ_FIELDS = ("round", "mean_acc", "fair_acc", "dp", "eo",
                "worst_cluster_acc", "cluster_churn")


def _slice_run_events(events, name):
    """The event window belonging to run ``name`` when one JSONL holds
    several runs: everything between the ``run.begin`` preceding the
    matching ``run.end`` and that ``run.end``. Falls back to the whole
    stream when the boundaries are absent (single-run logs, crashes)."""
    end = next((i for i, e in enumerate(events)
                if e.get("name") == "run.end" and e.get("run") == name),
               None)
    if end is None:
        return events
    begin = max((i for i in range(end)
                 if events[i].get("name") == "run.begin"), default=0)
    return events[begin:end + 1]


def settlement_round(evals) -> "int | None":
    """First eval round after which cluster assignment never changed
    again (paper Fig. 9's settlement) — ``None`` when churn was never
    observed or never stopped."""
    churned = [e["round"] for e in evals if e.get("cluster_churn", 0) > 0]
    if not churned:
        return None
    later = [e["round"] for e in evals if e["round"] > churned[-1]]
    return min(later) if later else None


def build_run_report(manifest: dict, events) -> dict:
    """Join one run's manifest dict with its event stream into the
    report payload (pure data — :func:`render_run_markdown` formats)."""
    events = _slice_run_events(events, manifest.get("name"))
    evals = [e for e in events if e.get("type") == "eval"]
    trajectory = {f: [e.get(f) for e in evals] for f in _TRAJ_FIELDS}
    health_events = [e for e in events
                     if str(e.get("name", "")).startswith("health.")]
    return {
        "name": manifest.get("name"),
        "kind": manifest.get("kind"),
        "fingerprint": manifest.get("fingerprint"),
        "settings": manifest.get("settings", {}),
        "n_evals": len(evals),
        "trajectory": trajectory,
        "settlement_round": settlement_round(evals),
        "health": manifest.get("health"),
        "health_events": health_events,
        "timing": manifest.get("timing", {}),
        "cache": manifest.get("cache"),
    }


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def _md_table(headers, rows) -> list:
    lines = ["| " + " | ".join(headers) + " |",
             "|" + "|".join("---" for _ in headers) + "|"]
    lines += ["| " + " | ".join(_fmt(c) for c in row) + " |"
              for row in rows]
    return lines


def render_run_markdown(report: dict) -> str:
    lines = [f"# Run report: {report['name']}",
             "",
             f"- kind: `{report['kind']}`",
             f"- fingerprint: `{report['fingerprint']}`"]
    for k, v in sorted(report.get("settings", {}).items()):
        lines.append(f"- {k}: `{v}`")
    health = report.get("health")
    lines += ["", "## Health",
              f"**verdict: {health['verdict'] if health else 'n/a'}**"]
    for issue in (health or {}).get("issues", ()):
        lines.append(
            f"- `{issue['rule']}` [{issue['severity']}] rounds "
            f"{issue['round_start']}-{issue['round_end']}: "
            f"{issue['detail']} (value={_fmt(issue['value'])})")
    if health and not health.get("issues"):
        lines.append("- no issues")
    lines += ["", "## Fairness trajectory"]
    traj = report["trajectory"]
    if report["n_evals"]:
        rows = list(zip(*(traj[f] for f in _TRAJ_FIELDS)))
        lines += _md_table(_TRAJ_FIELDS, rows)
        settle = report["settlement_round"]
        lines.append("")
        lines.append(
            f"settlement round: {settle}" if settle is not None
            else "settlement round: n/a (no churn observed, or still "
                 "churning at the last eval)")
    else:
        lines.append("no eval records (trace missing or run had no evals)")
    timing = report.get("timing", {})
    spans = timing.get("spans", {})
    if spans:
        lines += ["", "## Timing"]
        lines += _md_table(
            ("span", "count", "total_s"),
            [(name, s["count"], s["total_s"])
             for name, s in sorted(spans.items(),
                                   key=lambda kv: -kv[1]["total_s"])])
    cache = report.get("cache")
    if cache:
        lines += ["", "## Compile cache",
                  "- " + ", ".join(f"{k}={v}" for k, v in
                                   sorted(cache.items())
                                   if not isinstance(v, (dict, list)))]
    return "\n".join(lines) + "\n"


def build_sweep_report(sweep: dict) -> dict:
    """The report payload for a ``run_sweep`` JSON (``cells`` key)."""
    cells = []
    for name, cell in sweep.get("cells", {}).items():
        summary = cell.get("summary", {})
        fa = summary.get("best_fair_acc") or {}
        cells.append({
            "name": name,
            "algo": cell.get("algo"),
            "net": cell.get("net"),
            "error": cell.get("error"),
            "skipped": cell.get("skipped", False),
            "health": cell.get("health"),
            "best_fair_acc": fa.get("mean"),
            "dp": (summary.get("dp") or {}).get("mean"),
            "eo": (summary.get("eo") or {}).get("mean"),
            "fairness_trajectory": summary.get("fairness_trajectory"),
        })
    return {"kind": "sweep", "seeds": sweep.get("seeds"),
            "wall_s": sweep.get("wall_s"), "cache": sweep.get("cache"),
            "cells": cells}


def render_sweep_markdown(report: dict) -> str:
    lines = ["# Sweep report", "",
             f"- seeds: `{report.get('seeds')}`",
             f"- wall_s: {_fmt(report.get('wall_s'))}",
             "", "## Cells"]
    rows = []
    for c in report["cells"]:
        verdict = (c["health"] or {}).get("verdict") if c["health"] else None
        status = ("ERROR" if c["error"] else
                  "skipped" if c["skipped"] else verdict or "-")
        rows.append((c["name"], c["algo"], c["net"], status,
                     c["best_fair_acc"], c["dp"], c["eo"]))
    lines += _md_table(("cell", "algo", "net", "health",
                        "best_fair_acc", "dp", "eo"), rows)
    return "\n".join(lines) + "\n"


def build_report(path, jsonl=None) -> "tuple[dict, str]":
    """Load ``path`` (run manifest or sweep JSON), build the payload,
    and return ``(report_dict, markdown)``."""
    path = pathlib.Path(path)
    data = json.loads(path.read_text())
    if "cells" in data:
        report = build_sweep_report(data)
        return report, render_sweep_markdown(report)
    manifest = RunManifest.load(path).to_json()
    trace = jsonl if jsonl is not None else manifest.get(
        "settings", {}).get("jsonl")
    events = read_jsonl(trace) if trace else []
    report = build_run_report(manifest, events)
    return report, render_run_markdown(report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a run manifest or sweep JSON into a report.")
    ap.add_argument("path", help="run manifest .json or run_sweep .json")
    ap.add_argument("--jsonl", default=None,
                    help="JSONL trace (default: manifest settings['jsonl'])")
    ap.add_argument("--out", default=None,
                    help="write the report here instead of stdout")
    ap.add_argument("--json", action="store_true",
                    help="emit the report payload as JSON, not markdown")
    args = ap.parse_args(argv)
    report, md = build_report(args.path, jsonl=args.jsonl)
    text = (json.dumps(report, indent=2, default=repr)
            if args.json else md)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text)
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
