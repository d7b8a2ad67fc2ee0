"""repro_torch.sweep — seed sweeps over one shared engine cache.

The port's counterpart of ``repro.sweep``, on the ideal medium. The
paper's headline numbers are multi-seed grids: accuracy, fairness and
bytes-to-target per (algorithm, cluster layout, dataset) cell, averaged
over seeds. ``run_sweep`` runs such a grid through one
:class:`~repro_torch.core.cache.EngineCache`, so each cell captures its
rounds once and every further seed runs warm, bit for bit a fresh
``run_experiment`` call; ``aggregate_cell`` gives each cell's mean/std
tables, JSON-ready.

Usage::

    from repro_torch.sweep import SweepCell, run_sweep

    cells = [SweepCell(name=a, algo=a, cfg=cfg, dataset=ds, rounds=400,
                       kwargs=dict(eval_every=40, local_steps=10))
             for a in ("facade", "el")]
    sweep = run_sweep(cells, seeds=range(8), targets=(0.7,),
                      json_path="results/sweep.json", ckpt_dir="build/ck")
    sweep.cell("facade").summary["best_fair_acc"]
"""
from repro_torch.core.cache import (EngineCache, EngineSpec,  # noqa: F401
                                    data_fingerprint)
from .aggregate import aggregate_cell  # noqa: F401
from .driver import (CellResult, SweepCell, SweepResult,  # noqa: F401
                     run_sweep)
