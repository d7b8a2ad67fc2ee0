"""The port's seed sweep (``repro_torch.sweep``) on the CPU.

``aggregate_cell`` against the reference's on the same result objects
(equal dicts); ``run_sweep``'s runs against fresh ``run_experiment`` calls
(bit for bit: ``torch.equal`` on every parameter leaf, ``==`` on every
history), a ``compile_count`` flat after each cell's first seed, the
``ckpt_dir`` skip of completed cells and the resume of a killed one, a
failing cell recorded while the grid goes on, refused grids; and, with
the port's default draws replaced by the reference's
(``torch_caps.JaxDraws``), its summaries against the reference's
``run_sweep``: stop rounds, bytes and eval rounds exact, accuracies and
fair accuracies within 0.1 (``tests/test_torch_engine.py``'s
tolerance)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.sweep import SweepCell as RefSweepCell
from repro.sweep import aggregate_cell as ref_aggregate_cell
from repro.sweep import run_sweep as ref_run_sweep
from repro_torch import checkpoint
from repro_torch.comm import CommLog
from repro_torch.configs import facade_paper
from repro_torch.core import engine, runner
from repro_torch.data import synthetic
from repro_torch.obs import EvalFrame
from repro_torch.sweep import (EngineCache, SweepCell, aggregate_cell,
                               run_sweep)
from repro_torch.tree import tree_leaves
from torch_caps import JaxDraws

torch.set_num_threads(1)
TOL = 0.1
CFG = facade_paper.lenet(smoke=True).replace(n_classes=4)
KW = dict(k=2, degree=2, local_steps=2, batch_size=4, lr=0.05, eval_every=2)
SEEDS = (0, 1)
EXTRA = {"facade": {"head_jitter": 0.05, "warmup_rounds": 1}}


@pytest.fixture(scope="module")
def tiny_ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8, seed=3)
    return synthetic.make_clustered_data(spec, (3, 1), ("rot0", "rot180"))


def _cell(algo, ds, rounds=4, name=None, **over):
    return SweepCell(name=name or algo, algo=algo, cfg=CFG, dataset=ds,
                     rounds=rounds,
                     kwargs={**KW, **EXTRA.get(algo, {}), "device": "cpu",
                             **over})


def _cells(ds):
    return [_cell("facade", ds), _cell("el", ds)]


def _fresh(cell, seed):
    return runner.run_experiment(cell.algo, cell.cfg, cell.dataset,
                                 rounds=cell.rounds, seed=seed,
                                 **cell.kwargs)


def assert_same_run(a, b):
    for x, y in zip(tree_leaves(a.models), tree_leaves(b.models),
                    strict=True):
        assert torch.equal(x, y)
    assert a.acc_per_cluster == b.acc_per_cluster
    assert a.fair_acc == b.fair_acc and a.final_acc == b.final_acc
    assert (a.dp, a.eo) == (b.dp, b.eo)
    for col in ("rounds", "bytes", "seconds", "acc", "evaled"):
        assert getattr(a.comm, col) == getattr(b.comm, col), col
    assert len(a.cluster_history) == len(b.cluster_history)
    for (r1, c1), (r2, c2) in zip(a.cluster_history, b.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, c2)
    assert a.eval_frames == b.eval_frames


def _results(seed: int, n_seeds: int = 4, k: int = 2):
    """Per-seed ``RunResult``s drawn from a numpy seed: eval every 2 of 8
    rounds, some seeds stopped early (a ``target_acc`` exit), random
    accuracies, fairness gaps and bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_seeds):
        stop = int(rng.choice([4, 6, 8]))
        comm = CommLog()
        evals, frames = [], []
        for rnd in range(1, stop + 1):
            rb, rs = float(rng.uniform(1e5, 1e6)), float(rng.uniform(0, 9))
            if rnd % 2:
                comm.record(rnd, rb, round_s=rs)
                continue
            accs = rng.uniform(0, 1, k).tolist()
            comm.record(rnd, rb, float(np.mean(accs)), round_s=rs)
            evals.append((rnd, accs))
            frames.append(EvalFrame(
                round=rnd, mean_acc=float(np.mean(accs)),
                fair_acc=float(rng.uniform()), dp=float(rng.uniform()),
                eo=float(rng.uniform()), worst_cluster_acc=min(accs),
                acc=tuple(accs), cluster_ids=tuple(range(k)),
                acc_core=float(np.mean(accs)), acc_edge=0.0, tier_gap=0.0,
                cluster_churn=float(rng.integers(0, 4))))
        out.append(runner.RunResult(
            algo="facade", acc_per_cluster=evals,
            fair_acc=[(f.round, f.fair_acc) for f in frames],
            dp=frames[-1].dp, eo=frames[-1].eo, comm=comm,
            cluster_history=[], final_acc=evals[-1][1],
            eval_frames=frames))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_aggregate_cell_equals_the_references(seed):
    results = _results(seed)
    targets = (0.2, 0.5, 0.9, 2.0)
    assert aggregate_cell(results, targets) == \
        ref_aggregate_cell(results, targets)
    with pytest.raises(ValueError, match="at least one"):
        aggregate_cell([])


def test_sweep_runs_equal_fresh_calls(tiny_ds):
    """Two cells, two seeds through one cache: each seed's run is a fresh
    call's, and the cache's compile count stays flat after each cell's
    first seed (FACADE's two captured rounds, EL's one, one evaluator
    shared by both cells)."""
    cache = EngineCache()
    first = run_sweep(_cells(tiny_ds), SEEDS[:1], cache=cache)
    assert [c.cache_stats["compiles"] for c in first.cells] == [3, 4]
    sweep = run_sweep(_cells(tiny_ds), SEEDS, cache=cache)
    assert cache.compile_count == 4
    assert (cache.misses, cache.hits) == (2, 2 + 2 * len(SEEDS) - 2)
    for cres in sweep.cells:
        assert cres.error is None and not cres.skipped
        assert cres.summary["n_seeds"] == len(SEEDS)
        for seed, got in zip(SEEDS, cres.results, strict=True):
            assert_same_run(_fresh(cres.cell, seed), got)


def test_a_rerun_with_ckpt_dir_skips_completed_cells(tiny_ds, tmp_path,
                                                     monkeypatch):
    first = run_sweep(_cells(tiny_ds), SEEDS, ckpt_dir=tmp_path,
                      targets=(0.0, 2.0), json_path=tmp_path / "s.json")
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["el-s0.npz", "el-s1.npz", "el.manifest.json",
                     "el.summary.json", "facade-s0.npz", "facade-s1.npz",
                     "facade.manifest.json", "facade.summary.json",
                     "s.json", "s.json.manifest.json"]
    blob = json.loads((tmp_path / "s.json").read_text())
    assert blob["cells"]["el"]["summary"]["to_target"]["2"]["bytes"] is None

    def never(*a, **k):
        raise AssertionError("a skipped cell dispatched a segment")

    monkeypatch.setattr(engine.SegmentEngine, "dispatch_segment", never)
    again = run_sweep(_cells(tiny_ds), SEEDS, ckpt_dir=tmp_path,
                      targets=(0.0, 2.0))
    assert [c.skipped for c in again.cells] == [True, True]
    for a, b in zip(first.cells, again.cells):
        assert b.results == [] and b.error is None
        assert b.summary == json.loads(json.dumps(a.summary))
    # other targets: another fingerprint, so the cells run again (each
    # seed's finished checkpoint replays without a dispatch)
    other = run_sweep(_cells(tiny_ds), SEEDS, ckpt_dir=tmp_path)
    assert [c.skipped for c in other.cells] == [False, False]
    for a, b in zip(first.cells, other.cells):
        for x, y in zip(a.results, b.results, strict=True):
            assert_same_run(x, y)


class Killed(BaseException):
    """A kill the sweep does not catch as a cell failure."""


def test_a_killed_sweep_resumes(tiny_ds, tmp_path, monkeypatch):
    """Killed at the eighth segment dispatch (EL's first seed's second
    segment, after FACADE's two seeds of three segments each): the rerun
    skips FACADE, resumes EL's first seed from its checkpoint and runs
    the second."""
    orig = engine.SegmentEngine.dispatch_segment
    calls = []

    def killer(self, *a, **k):
        if len(calls) == 7:
            raise Killed
        calls.append(1)
        return orig(self, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(engine.SegmentEngine, "dispatch_segment", killer)
        with pytest.raises(Killed):
            run_sweep(_cells(tiny_ds), SEEDS, ckpt_dir=tmp_path)
    meta = checkpoint.load(str(tmp_path / "el-s0.npz"))[1]
    assert (meta["next_segment"], meta["finished"]) == (1, False)
    assert not (tmp_path / "el-s1.npz").exists()
    sweep = run_sweep(_cells(tiny_ds), SEEDS, ckpt_dir=tmp_path)
    assert [c.skipped for c in sweep.cells] == [True, False]
    el = sweep.cell("el")
    for seed, got in zip(SEEDS, el.results, strict=True):
        assert_same_run(_fresh(el.cell, seed), got)


def test_a_failing_cell_is_recorded_and_the_grid_continues(tiny_ds):
    bad = _cell("sgp", tiny_ds)
    sweep = run_sweep([bad, _cell("el", tiny_ds)], SEEDS)
    assert "not ported" in sweep.cell("sgp").error
    assert sweep.cell("sgp").summary == {"error": sweep.cell("sgp").error}
    assert sweep.cell("el").error is None
    with pytest.raises(RuntimeError, match="every sweep cell failed"):
        run_sweep([bad], SEEDS)
    with pytest.raises(KeyError, match="no sweep cell"):
        sweep.cell("nope")


@pytest.mark.parametrize("bad,match", [
    ("empty", "empty cell grid"), ("no-seeds", "no seeds"),
    ("dup", "duplicate"), ("seed", "owns 'seed'"), ("ckpt", "owns 'ckpt'"),
    ("draws", "owns 'draws'"), ("net", "netsim"),
    ("cache+max_entries", "max_entries"),
])
def test_refused_grids(tiny_ds, bad, match):
    cells, seeds, kw = [_cell("el", tiny_ds)], SEEDS, {}
    if bad == "empty":
        cells = []
    elif bad == "no-seeds":
        seeds = iter(())
    elif bad == "dup":
        cells = cells * 2
    elif bad in ("seed", "ckpt", "draws"):
        cells[0].kwargs[bad] = {"seed": 7, "ckpt": "x.npz",
                                "draws": runner.TorchDraws(7)}[bad]
    elif bad == "net":              # an unknown netsim preset
        cells[0].net = "no-such-preset"
    else:
        kw = {"cache": EngineCache(), "max_entries": 2}
    with pytest.raises(ValueError, match=match):
        run_sweep(cells, seeds, **kw)


def test_the_sweep_matches_the_references(tiny_ds, monkeypatch):
    """The port's default draws replaced by the reference's: a two-cell,
    two-seed sweep against the reference's ``run_sweep``."""
    monkeypatch.setattr(runner, "TorchDraws", JaxDraws)
    targets = (0.0, 2.0)
    got = run_sweep(_cells(tiny_ds), SEEDS, targets=targets)
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    want = ref_run_sweep(
        [RefSweepCell(name=c.cell.name, algo=c.cell.algo, cfg=rcfg,
                      dataset=tiny_ds, rounds=c.cell.rounds,
                      kwargs={k: v for k, v in c.cell.kwargs.items()
                              if k != "device"})
         for c in got.cells], SEEDS, targets=targets)
    for g, w in zip(got.cells, want.cells, strict=True):
        gs, ws = g.summary, w.summary
        for key in ("n_seeds", "eval_rounds", "stop_round", "total_bytes",
                    "sim_seconds"):
            assert gs[key] == ws[key], key
        assert gs["to_target"]["2"] == ws["to_target"]["2"]
        assert gs["to_target"]["0"]["bytes"] == ws["to_target"]["0"]["bytes"]
        for a, b in zip(gs["trajectory"], ws["trajectory"], strict=True):
            assert (a["round"], a["n"]) == (b["round"], b["n"])
            np.testing.assert_allclose(a["acc_mean"], b["acc_mean"],
                                       atol=TOL)
            assert abs(a["fair_acc_mean"] - b["fair_acc_mean"]) <= TOL
        np.testing.assert_allclose(gs["final_acc_mean"],
                                   ws["final_acc_mean"], atol=TOL)
        for key in ("dp", "eo"):
            assert abs(gs[key]["mean"] - ws[key]["mean"]) <= TOL, key
