"""The port's run health and reports (``repro_torch.obs.health``,
``repro_torch.obs.report``) against the reference's.

* The port's ``evaluate`` and the reference's on the hand-built tables of
  the reference's observatory tests (every rule firing and staying quiet,
  ``disable``, an inclusion floor in the context): the same report, its
  verdict and every issue (rule, severity, round range, value, detail),
  and the same ``health.<rule>`` events.
* At run level: an unguarded NaN storm is ``fail`` with ``nonfinite``
  while the clean run is a quiet ``ok``, and the verdict survives the
  manifest on disk.
* Reports: the port's ``render_run_markdown`` and
  ``render_sweep_markdown`` give the reference's text, string for string,
  on a hand-built manifest and JSONL, on a port run's own and on a port
  sweep's JSON; the report CLI writes markdown and JSON."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.obs import health as ref_health
from repro.obs import report as ref_report
from repro_torch.configs import facade_paper
from repro_torch.core import runner
from repro_torch.data import synthetic
from repro_torch.netsim import NetworkConfig
from repro_torch.obs import (HealthConfig, HealthContext, HealthReport, Obs,
                             ObsConfig, RunManifest, evaluate_health,
                             worst_verdict)
from repro_torch.obs import report
from repro_torch.resil import FaultConfig
from repro_torch.sweep import SweepCell, run_sweep

torch.set_num_threads(1)
CFG = facade_paper.lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=4, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=2, seed=0, device="cpu")


@pytest.fixture(scope="module")
def tiny_ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8, seed=3)
    return synthetic.make_clustered_data(spec, (3, 1), ("rot0", "rot180"))


# ------------------------------------------------- the rule tables ------
def _frames(rounds, **cols):
    n = len(rounds)
    table = {"round": np.asarray(rounds, np.int64),
             "update_norm": np.full(n, 0.5), "param_norm": np.full(n, 1.0),
             "crashed": np.zeros(n), "quarantined": np.zeros(n),
             "inclusion": np.ones(n), "cluster_switches": np.zeros(n)}
    for k, v in cols.items():
        table[k] = np.asarray(v, np.float64)
    return table


def _evals(rounds, mean_acc):
    return {"round": np.asarray(rounds, np.int64),
            "mean_acc": np.asarray(mean_acc, np.float64)}


EVEN = list(range(2, 22, 2))
FLOOR = dict(n=4, warmup_rounds=2, inclusion_floor=0.9)
TABLES = {
    "clean": (_frames(range(1, 7)), _evals([2, 4, 6], [0.3, 0.5, 0.7]),
              {}, {}),
    "empty": (_frames([]), _evals([], []), {}, {}),
    "nonfinite": (_frames([1, 2, 3, 4, 5, 6],
                          update_norm=[0.5, np.nan, np.inf, 0.5, 0.5,
                                       np.nan]), _evals([], []), {}, {}),
    "divergence": (_frames([1, 2, 3, 4], param_norm=[1.0, 1.0, 2e6, 1.0]),
                   _evals([], []), {}, {}),
    "quarantine": (_frames([1, 2, 3, 4], crashed=[0, 3, 3, 0]),
                   _evals([], []), {}, {}),
    "floor_no_context": (_frames(range(1, 9), inclusion=np.full(8, 0.5)),
                         _evals([], []), {}, {}),
    "floor": (_frames(range(1, 9), inclusion=np.full(8, 0.5)),
              _evals([], []), FLOOR, {}),
    "floor_in_slack": (_frames(range(1, 9), inclusion=np.full(8, 0.88)),
                       _evals([], []), FLOOR, {}),
    "flapping": (_frames(range(1, 17), cluster_switches=np.full(16, 4.0)),
                 _evals([], []), {}, {}),
    "settled": (_frames(range(1, 17)), _evals([], []), {}, {}),
    "stall": (_frames([]), _evals(EVEN, [0.3] * 10), {}, {}),
    "improving": (_frames([]), _evals(EVEN, np.linspace(0.1, 0.8, 10)),
                  {}, {}),
    "flat_accurate": (_frames([]), _evals(EVEN, [0.8] * 10), {}, {}),
    "few_evals": (_frames([]), _evals([2, 4], [0.3, 0.3]), {}, {}),
    "collapse": (_frames([]), _evals([2, 4, 6, 8], [0.1, 0.5, 0.6, 0.2]),
                 {}, {}),
    "low_peak": (_frames([]), _evals([2, 4, 6], [0.1, 0.35, 0.05]), {}, {}),
    "nan_and_collapse": (_frames([1, 2], update_norm=[np.nan, 0.5]),
                         _evals([2, 4, 6, 8], [0.1, 0.5, 0.6, 0.2]), {}, {}),
    "disabled": (_frames([1, 2], update_norm=[np.nan, np.nan]),
                 _evals([], []), {}, {"disable": ("nonfinite",)}),
    "tuned": (_frames(range(1, 17), cluster_switches=np.full(16, 1.5),
                      crashed=np.full(16, 1.0)), _evals([], []),
              {"warmup_rounds": 4},
              {"flap_frac": 0.3, "flap_grace": 2, "quarantine_frac": 0.2}),
}


class _Events:
    def __init__(self):
        self.events = []

    def event(self, name, **kw):
        self.events.append({"name": name, **kw})


@pytest.mark.parametrize("case", sorted(TABLES))
def test_evaluate_equals_the_references(case):
    frames, evals, ctx, cfg = TABLES[case]
    ctx = {"n": 4, **ctx}
    got_ev, want_ev = _Events(), _Events()
    got = evaluate_health(HealthConfig(**cfg), HealthContext(**ctx), frames,
                          evals, tracer=got_ev)
    want = ref_health.evaluate(ref_health.HealthConfig(**cfg),
                               ref_health.HealthContext(**ctx), frames,
                               evals, tracer=want_ev)
    assert got.to_json() == want.to_json()
    assert [(i.rule, i.round_start, i.round_end) for i in got.issues] == [
        (i.rule, i.round_start, i.round_end) for i in want.issues]
    assert got_ev.events == want_ev.events
    assert HealthReport.from_json(json.loads(json.dumps(
        got.to_json()))).to_json() == got.to_json()


def test_the_rule_set_and_the_verdict_order_are_the_references():
    from repro_torch.obs.health import RULES
    assert list(RULES) == list(ref_health.RULES)
    assert [f.name for f in dataclasses.fields(HealthConfig)] == [
        f.name for f in dataclasses.fields(ref_health.HealthConfig)]
    for vs in ([], ["ok"], ["ok", "warn"], ["warn", "fail"], ["ok", "x"]):
        assert worst_verdict(vs) == ref_health.worst_verdict(vs)
    with pytest.raises(ValueError, match="unknown health rules"):
        HealthConfig(disable=("no_such_rule",))


# ------------------------------------------------- run-level verdicts ---
def test_nan_storm_fails_and_the_clean_run_is_quiet(tiny_ds, tmp_path):
    ideal = NetworkConfig.preset("ideal")
    clean = Obs(ObsConfig(), out_dir=tmp_path / "clean")
    runner.run_experiment("facade", CFG, tiny_ds, net=ideal, obs=clean, **KW)
    health = clean.manifests[-1].health
    assert health["verdict"] == "ok" and health["issues"] == []
    assert health["rounds_seen"] == 4 and health["evals_seen"] == 2
    assert not [e for e in clean.tracer.events
                if e["name"].startswith("health.")]
    storm = dataclasses.replace(ideal, faults=FaultConfig(
        corrupt_rate=0.6, corrupt_mode="nan", robust=False))
    for engine in (True, False):
        obs = Obs(ObsConfig(), out_dir=tmp_path / f"storm{engine}")
        runner.run_experiment("facade", CFG, tiny_ds, net=storm, obs=obs,
                              engine=engine, **KW)
        health = obs.manifests[-1].health
        assert health["verdict"] == "fail"
        assert "nonfinite" in {i["rule"] for i in health["issues"]}
        assert "health.nonfinite" in {e["name"] for e in obs.tracer.events}
        back = RunManifest.load(tmp_path / f"storm{engine}"
                                / "manifest_facade-seed0.json")
        assert back.health == health


# ------------------------------------------------------------ reports ---
def _fake_run(tmp_path, churn_last=0.0):
    """A manifest and JSONL trace shaped like a run's (the reference
    observatory tests' artifacts)."""
    def ev(rnd, dp, churn):
        return {"type": "eval", "round": rnd, "mean_acc": 0.5,
                "fair_acc": 0.6, "dp": dp, "eo": dp,
                "worst_cluster_acc": 0.4, "cluster_churn": churn}
    events = [
        {"type": "event", "name": "run.begin", "run": "facade-seed0"},
        ev(2, 0.4, 1.0), ev(4, 0.2, churn_last),
        {"type": "event", "name": "health.nonfinite", "severity": "fail",
         "round_start": 3, "round_end": 4, "value": 2.0, "detail": "x"},
        {"type": "event", "name": "run.end", "run": "facade-seed0"},
    ]
    trace = tmp_path / "trace.jsonl"
    trace.write_text("".join(json.dumps(e) + "\n" for e in events))
    manifest = RunManifest.build(
        kind="run", name="facade-seed0", spec="spec",
        settings={"jsonl": str(trace)},
        timing={"spans": {"dispatch": {"count": 2, "total_s": 1.5},
                          "drain": {"count": 2, "total_s": 0.25}}},
        cache={"compiles": 3, "entries": 1},
        health={"verdict": "fail", "rounds_seen": 4, "evals_seen": 2,
                "issues": [{"rule": "nonfinite", "severity": "fail",
                            "round_start": 3, "round_end": 4,
                            "value": 2.0, "detail": "poisoned"}]})
    return manifest.save(tmp_path / "manifest.json"), trace


def _same_report(path, **kw):
    got, got_md = report.build_report(path, **kw)
    want, want_md = ref_report.build_report(path, **kw)
    assert got_md == want_md
    assert json.dumps(got, default=repr, sort_keys=True) == json.dumps(
        want, default=repr, sort_keys=True)
    return got, got_md


@pytest.mark.parametrize("churn_last", [0.0, 2.0], ids=["settled",
                                                        "churning"])
def test_run_report_renders_as_the_references(tmp_path, churn_last):
    path, trace = _fake_run(tmp_path, churn_last)
    got, md = _same_report(path)
    assert got["n_evals"] == 2
    assert ("settlement round: 4" in md) == (churn_last == 0.0)
    trace.unlink()                    # a lost trace: manifest-only report
    got, md = _same_report(path)
    assert got["n_evals"] == 0 and "no eval records" in md


def test_a_port_runs_report_renders_as_the_references(tiny_ds, tmp_path):
    obs = Obs(ObsConfig(), jsonl=tmp_path / "run.jsonl", out_dir=tmp_path)
    runner.run_experiment("facade", CFG, tiny_ds, obs=obs, **KW)
    runner.run_experiment("el", CFG, tiny_ds, obs=obs, **KW)
    obs.sink.close()
    for name in ("facade-seed0", "el-seed0"):
        got, md = _same_report(tmp_path / f"manifest_{name}.json")
        assert got["n_evals"] == 2 and f"# Run report: {name}" in md
        assert "**verdict: ok**" in md and "## Timing" in md


def test_sweep_report_renders_as_the_references(tiny_ds, tmp_path):
    sweep = {"seeds": [0, 1], "wall_s": 1.0, "cells": {
        "facade/ideal": {"algo": "facade", "net": "ideal", "error": None,
                         "skipped": False, "health": {"verdict": "warn"},
                         "summary": {"best_fair_acc": {"mean": 0.8},
                                     "dp": {"mean": 0.1},
                                     "eo": {"mean": 0.2}}},
        "el/ideal": {"algo": "el", "net": "ideal", "error": "boom",
                     "skipped": False, "health": None, "summary": {}}}}
    fake = tmp_path / "fake.json"
    fake.write_text(json.dumps(sweep))
    got, md = _same_report(fake)
    assert got["kind"] == "sweep" and "ERROR" in md and "warn" in md
    kw = {k: v for k, v in KW.items() if k not in ("rounds", "seed")}
    cells = [SweepCell(name=a, algo=a, cfg=CFG, dataset=tiny_ds, rounds=2,
                       net="edge-v2", kwargs=kw) for a in ("facade", "el")]
    run_sweep(cells, (0, 1), json_path=tmp_path / "sweep.json",
              obs=Obs(ObsConfig()))
    got, md = _same_report(tmp_path / "sweep.json")
    assert [c["health"]["verdict"] for c in got["cells"]] == ["ok", "ok"]


def test_report_cli(tmp_path, capsys):
    path, _ = _fake_run(tmp_path)
    out = tmp_path / "report.md"
    assert report.main([str(path), "--out", str(out)]) == 0
    assert out.read_text() == ref_report.build_report(path)[1]
    assert report.main([str(path), "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["name"] == "facade-seed0" and payload["n_evals"] == 2
    assert report.main([str(path)]) == 0
    assert capsys.readouterr().out == ref_report.build_report(path)[1]
