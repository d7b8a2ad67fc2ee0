"""Sweep driver: fan (algorithm x netsim preset x config) cells over seeds
on one shared :class:`~repro_torch.core.cache.EngineCache`.

The counterpart of ``repro.sweep.driver``. Each
:class:`SweepCell` is one grid cell, everything static; only the seed
varies inside it. ``run_sweep`` routes every run through
:func:`repro_torch.core.runner.run_experiment` with the shared cache, so
a cell captures its rounds and builds its evaluator on the first seed and
every further seed runs warm, bit for bit a fresh ``run_experiment``
call's run.

Long grids survive a killed process (``ckpt_dir=``): every engine run
checkpoints per segment (``run_experiment(ckpt=...)``), so a killed cell
resumes mid-run, and every completed cell leaves a summary and a manifest
behind, so a rerun of the same sweep skips it (matched on a content
fingerprint of the cell's static description: algorithm, config, netsim
preset, dataset content, seeds, targets). A cell that raises is recorded on its
:class:`CellResult` and the remaining cells run; only a sweep where every
cell failed raises.

``obs=`` (a :class:`repro_torch.obs.Obs`) is shared by every run: a
``sweep.cell`` span wraps each cell's runs, ``sweep.cell_skipped`` and
``sweep.cell_failed`` events mark the others, and a cell's
``CellResult.health`` is the worst health verdict of its runs'
manifests.

Differences from the reference: there is no ``persist_dir`` (a CUDA
graph cannot be serialised; see :mod:`repro_torch.core.cache`); and
``run_sweep`` owns ``draws`` besides ``seed`` and ``ckpt``, since one
draws source in a cell's kwargs would give every seed one stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import time
from typing import Any, Sequence

from repro_torch.core.cache import EngineCache, data_fingerprint
from repro_torch.core.runner import run_experiment
from repro_torch.netsim import NetworkConfig
from repro_torch.obs import RunManifest, fingerprint, worst_verdict

from .aggregate import aggregate_cell

OWNED = ("seed", "ckpt", "draws", "obs")     # run_sweep sets these


@dataclasses.dataclass
class SweepCell:
    """One grid cell. ``kwargs`` are passed through to ``run_experiment``
    (``degree``, ``local_steps``, ``batch_size``, ``lr``, ``eval_every``,
    ``warmup_rounds``, ``target_acc``, ``device``, ...), everything but
    the keys ``run_sweep`` owns (:data:`OWNED`). ``net`` may be a
    :class:`~repro_torch.netsim.NetworkConfig`, a preset name
    (``"edge-churn"``) or ``None``."""
    name: str
    algo: str
    cfg: Any
    dataset: Any
    rounds: int
    net: Any = None
    kwargs: dict = dataclasses.field(default_factory=dict)

    def resolved_net(self):
        return (NetworkConfig.preset(self.net) if isinstance(self.net, str)
                else self.net)


@dataclasses.dataclass
class CellResult:
    cell: SweepCell
    seeds: tuple
    results: list          # per-seed RunResult, in ``seeds`` order
    summary: dict          # aggregate_cell(results, targets)
    cache_stats: dict = dataclasses.field(default_factory=dict)
    #                      cumulative EngineCache.stats() right after this
    #                      cell
    error: "str | None" = None   # repr of the exception that killed the
    #                      cell (results/summary then hold no metrics)
    skipped: bool = False  # completed in an earlier sweep run and skipped
    #                      here (summary reloaded from ckpt_dir; no
    #                      per-seed RunResults)
    health: "dict | None" = None  # under obs with a HealthConfig: the
    #                      worst verdict over the cell's runs and each
    #                      run's, {"verdict": ..., "runs": {name: ...}}


@dataclasses.dataclass
class SweepResult:
    cells: list
    seeds: tuple
    cache: EngineCache
    wall_s: float

    def cell(self, name: str) -> CellResult:
        for c in self.cells:
            if c.cell.name == name:
                return c
        raise KeyError(f"no sweep cell named {name!r}; "
                       f"know {[c.cell.name for c in self.cells]}")

    def to_json(self) -> dict:
        cells = {}
        for c in self.cells:
            net = c.cell.net
            cells[c.cell.name] = {
                "algo": c.cell.algo,
                "net": (net if isinstance(net, str) or net is None
                        else net.name),
                "rounds": c.cell.rounds,
                "kwargs": {k: repr(v) if not isinstance(
                    v, (int, float, str, bool, type(None))) else v
                    for k, v in c.cell.kwargs.items()},
                "summary": c.summary,
                "cache": c.cache_stats,
                "error": c.error,
                "skipped": c.skipped,
                "health": c.health,
            }
        return {"seeds": list(self.seeds), "wall_s": self.wall_s,
                "cache": self.cache.stats(), "cells": cells}

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=2, default=float))
        return path


def _cell_fingerprint(cell: SweepCell, net, seeds, targets) -> str:
    """Content hash of everything that shapes a cell's summary, from reprs
    of frozen configs (the resolved ``net`` among them) and
    :func:`data_fingerprint` of the dataset, never ``repr(cell)``, whose
    dataset repr can embed memory addresses and would break
    skip-on-rerun across processes."""
    return fingerprint({
        "name": cell.name, "algo": cell.algo, "cfg": repr(cell.cfg),
        "rounds": cell.rounds, "net": repr(net),
        "kwargs": {k: repr(v) for k, v in sorted(cell.kwargs.items())},
        "data": data_fingerprint(cell.dataset),
        "seeds": list(seeds), "targets": list(targets)})


def run_sweep(cells: Sequence[SweepCell], seeds: Sequence[int], *,
              cache: EngineCache | None = None, targets: Sequence[float] = (),
              json_path=None, obs=None, ckpt_dir=None,
              max_entries: int | None = None,
              verbose: bool = False) -> SweepResult:
    """Run every cell over every seed, reusing captured rounds.

    ``cache``: share one :class:`EngineCache` across calls to keep rounds
    captured between sweeps (``None`` builds a fresh one for this sweep).
    ``max_entries``: forwarded to that fresh cache (an LRU bound on its
    entries for large grids); refused together with ``cache``, which
    carries its own settings.
    ``targets``: accuracies for the per-cell bytes/seconds-to-target table.
    ``json_path``: if set, the aggregated sweep is written there as JSON,
    with a :class:`~repro_torch.obs.RunManifest` next to it
    (``<json_path>.manifest.json``; under ``obs`` its timing is the
    tracer's rollup and its health the cells' verdicts).
    ``obs``: a :class:`repro_torch.obs.Obs` shared by every run of the
    sweep: a ``sweep.cell`` span around each cell's runs, which record
    their own telemetry into it; each cell's ``CellResult.health`` rolls
    up its runs' verdicts.
    ``ckpt_dir``: if set, engine runs checkpoint per segment under
    ``<ckpt_dir>/<cell>-s<seed>.npz``, and a completed cell writes
    ``<cell>.summary.json`` and ``<cell>.manifest.json`` there; rerunning
    the same sweep skips completed cells (fingerprint match) and resumes
    the run that was killed.

    A cell with a key ``run_sweep`` owns in its kwargs, and duplicate
    cell names are refused up front with ``ValueError``, as are an empty
    grid and no seeds; a cell with an unknown preset name raises
    ``ValueError`` when its turn comes. A failing cell is
    recorded (``CellResult.error``) and the grid continues;
    ``RuntimeError`` is raised only when every cell failed.
    """
    if cache is not None and max_entries is not None:
        raise ValueError(
            "pass max_entries OR a prebuilt cache, not both: an existing "
            "EngineCache already carries its own settings (build it with "
            "EngineCache(max_entries=...))")
    cache = cache if cache is not None else EngineCache(
        max_entries=max_entries)
    tracer = obs.tracer if obs is not None else None
    seeds = tuple(int(s) for s in seeds)
    cells = list(cells)
    if not cells:
        raise ValueError("run_sweep got an empty cell grid; build at "
                         "least one SweepCell")
    if not seeds:
        raise ValueError("run_sweep got no seeds; pass at least one "
                         "(e.g. seeds=range(3))")
    names = [c.name for c in cells]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate sweep cell names: {names}")
    for cell in cells:
        for owned in OWNED:
            if owned in cell.kwargs:
                raise ValueError(
                    f"cell {cell.name!r} sets {owned!r} in kwargs; "
                    f"run_sweep owns {owned!r} — pass seeds/ckpt_dir to "
                    "run_sweep instead")
    if ckpt_dir is not None:
        ckpt_dir = pathlib.Path(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    out = []
    for cell in cells:
        net = cell.resolved_net()
        if ckpt_dir is not None:
            cell_fp = _cell_fingerprint(cell, net, seeds, targets)
            man_path = ckpt_dir / f"{cell.name}.manifest.json"
            sum_path = ckpt_dir / f"{cell.name}.summary.json"
            if man_path.exists() and sum_path.exists():
                man = RunManifest.load(man_path)
                if man.settings.get("cell_fingerprint") == cell_fp:
                    summary = json.loads(sum_path.read_text())
                    out.append(CellResult(cell, seeds, [], summary,
                                          cache_stats=cache.stats(),
                                          skipped=True))
                    if tracer is not None:
                        tracer.event("sweep.cell_skipped", cell=cell.name)
                    if verbose:
                        print(f"  [sweep] {cell.name}: skipped "
                              "(completed in an earlier run)")
                    continue
        results = []
        m0 = len(obs.manifests) if obs is not None else 0
        try:
            with (tracer.span("sweep.cell", cell=cell.name)
                  if tracer is not None else contextlib.nullcontext()):
                for seed in seeds:
                    ckpt = None
                    if (ckpt_dir is not None
                            and cell.kwargs.get("engine", True)):
                        ckpt = str(ckpt_dir / f"{cell.name}-s{seed}.npz")
                    results.append(run_experiment(
                        cell.algo, cell.cfg, cell.dataset,
                        rounds=cell.rounds, seed=seed, cache=cache,
                        ckpt=ckpt, net=net, obs=obs, **cell.kwargs))
            summary = aggregate_cell(results, targets=targets)
        except Exception as e:  # noqa: BLE001 — one bad cell, whole grid
            out.append(CellResult(cell, seeds, results,
                                  {"error": repr(e)},
                                  cache_stats=cache.stats(),
                                  error=repr(e)))
            if tracer is not None:
                tracer.event("sweep.cell_failed", cell=cell.name,
                             error=repr(e))
            if verbose:
                print(f"  [sweep] {cell.name}: FAILED ({e!r}); "
                      "continuing with the remaining cells")
            continue
        health = None
        if obs is not None and obs.health_config is not None:
            # one manifest per run of this cell: the cell's verdict is the
            # worst over its seeds
            runs = {m.name: (m.health or {}).get("verdict", "ok")
                    for m in obs.manifests[m0:]}
            health = {"verdict": worst_verdict(runs.values()),
                      "runs": runs}
        out.append(CellResult(cell, seeds, results, summary,
                              cache_stats=cache.stats(), health=health))
        if ckpt_dir is not None:
            sum_path.write_text(json.dumps(summary, indent=2,
                                           default=float))
            RunManifest.build(
                kind="sweep-cell", name=cell.name, spec=repr(cell.cfg),
                settings={"cell_fingerprint": cell_fp,
                          "seeds": list(seeds), "targets": list(targets),
                          "net": repr(net)},
                cache=cache.stats()).save(man_path)
        if verbose:
            fa = summary["best_fair_acc"]
            print(f"  [sweep] {cell.name}: best_fair_acc="
                  f"{fa['mean']:.3f}±{fa['std']:.3f} over {len(seeds)} "
                  f"seeds ({cache.stats()['compiles']} compiles so far)")
    if all(c.error is not None for c in out):
        raise RuntimeError(
            f"every sweep cell failed ({len(out)}/{len(out)}): "
            + "; ".join(f"{c.cell.name}: {c.error}" for c in out))
    sweep = SweepResult(out, seeds, cache, time.perf_counter() - t0)
    if json_path is not None:
        path = sweep.save(json_path)
        cell_verdicts = {c.cell.name: c.health["verdict"]
                         for c in out if c.health is not None}
        RunManifest.build(
            kind="sweep", name=path.stem,
            spec=[repr(c.cell) for c in out],
            settings={"seeds": list(seeds), "cells": names,
                      "targets": list(targets)},
            timing=(tracer.rollup() if tracer is not None
                    else {"wall_s": sweep.wall_s}),
            cache=cache.stats(),
            health=({"verdict": worst_verdict(cell_verdicts.values()),
                     "cells": cell_verdicts} if cell_verdicts else None)
        ).save(path.with_suffix(path.suffix + ".manifest.json"))
    return sweep
