"""Run telemetry of the port: per-round device frames, per-eval fairness
frames, host spans, run health, manifests and reports (the port of
``repro.obs``).

Four layers, independent of one another:

* **device**: :class:`ObsConfig` and :class:`MetricsFrame`
  (:mod:`.frame`), a fixed set of per-round float32 scalars (update and
  parameter norms, cluster switches, delivered edges, the per-tier byte
  split, the gossip-staleness histogram, inclusion, fault counters)
  computed on the card inside the captured round and drained in the
  segment's one copy to the host;
* **eval**: :class:`EvalFrame` (:mod:`.evalframe`), one fairness
  observation per eval (DP, EO, fair, worst-cluster and per-tier
  accuracy, cluster churn), host bookkeeping over what the evaluator
  already brought back, recorded whether or not an ``ObsConfig`` is set;
* **host**: :class:`Tracer` (:mod:`.trace`), nested spans around capture,
  dispatch, drain, eval and checkpoint, cache events and an optional
  ``torch.profiler`` trace; the :mod:`.health` rules judging both tables
  into a per-run verdict; :mod:`.report` rendering a manifest and its
  JSONL (``python -m repro_torch.obs.report``);
* **disk**: :class:`JsonlSink` and :class:`RunManifest` (:mod:`.sink`).

Usage, any algorithm, either driver, with or without ``net`` and
``topo``::

    from repro_torch.core.runner import run_experiment
    from repro_torch.obs import Obs, ObsConfig

    obs = Obs(ObsConfig(), jsonl="build/obs/run.jsonl",
              out_dir="build/obs")
    res = run_experiment("facade", cfg, ds, rounds=100, obs=obs)
    obs.frames_table()["cluster_switches"]   # per-round settlement curve
    obs.eval_table()["dp"]                   # DP gap over training
    obs.manifests[-1].health["verdict"]      # "ok" | "warn" | "fail"
    obs.tracer.rollup()                      # where the host time went

``obs=None`` (the default) is the run without telemetry bit for bit, and
an enabled ``Obs`` observes that same run: the frame only reads. Only
:class:`ObsConfig` is an ``EngineSpec`` key component; the sink, health
rules, output directory and profiler settings on :class:`Obs` never fork
the key or capture anything again.
"""
from __future__ import annotations

import pathlib
from typing import Any

import numpy as np

from .evalframe import (EVAL_FIELDS, EVAL_SCALAR_FIELDS,  # noqa: F401
                        EvalFrame, compute_eval_frame, frame_record,
                        tiers_of)
from .evalframe import eval_table as _eval_table
from .frame import (FRAME_FIELDS, MetricsFrame, ObsConfig,  # noqa: F401
                    compute_frame, frame_hook, frame_row, frame_width,
                    frames_of_rows)
from .health import (HealthConfig, HealthContext,  # noqa: F401
                     HealthIssue, HealthReport, worst_verdict)
from .health import evaluate as evaluate_health  # noqa: F401
from .sink import (JsonlSink, RunManifest, bench_stamp,  # noqa: F401
                   fingerprint, read_jsonl)
from .trace import Tracer, maybe_profile  # noqa: F401


class Obs:
    """Host-side telemetry context for one or more runs.

    ``config``: the device-side :class:`ObsConfig` (``None``: spans and
    manifests only, no frame, and no cache-key fork); ``health``: the
    :class:`HealthConfig` each run is judged against at its end (``None``
    skips it); ``jsonl``/``sink``: where records go (a ``jsonl`` path
    builds a :class:`JsonlSink`); ``out_dir``: where per-run manifests are
    written; ``profile_dir``: a ``torch.profiler`` trace directory.

    One ``Obs`` may span many runs (a sweep shares one): frames, eval
    frames and manifests accumulate, ``run.begin``/``run.end`` events mark
    the runs in the JSONL, and :meth:`run_frames_table` /
    :meth:`run_eval_table` give the current run's part."""

    def __init__(self, config: "ObsConfig | None" = ObsConfig(), *,
                 health: "HealthConfig | None" = HealthConfig(),
                 jsonl=None, sink=None, out_dir=None, profile_dir=None):
        self.config = config
        self.health_config = health
        self.sink = sink if sink is not None else (
            JsonlSink(jsonl) if jsonl is not None else None)
        self.tracer = Tracer(sink=self.sink)
        self.out_dir = pathlib.Path(out_dir) if out_dir is not None else None
        self.profile_dir = profile_dir
        self.frames: list[tuple] = []      # (rounds [m], MetricsFrame [m,...])
        self.eval_frames: list[EvalFrame] = []
        self.manifests: list[RunManifest] = []
        self._frames_mark = 0              # where the current run's frames
        self._evals_mark = 0               # and eval frames begin

    # -- run lifecycle ------------------------------------------------------
    def begin_run(self, **attrs: Any) -> None:
        self._frames_mark = len(self.frames)
        self._evals_mark = len(self.eval_frames)
        self.tracer.event("run.begin", **attrs)

    def end_run(self, manifest: RunManifest) -> RunManifest:
        self.manifests.append(manifest)
        if self.out_dir is not None:
            manifest.save(self.out_dir / f"manifest_{manifest.name}.json")
        self.tracer.event("run.end", run=manifest.name,
                          fingerprint=manifest.fingerprint)
        return manifest

    def profile(self):
        """Context manager: a ``torch.profiler`` trace under
        ``profile_dir`` when it is set (raising if the profiler fails),
        else a no-op."""
        return maybe_profile(self.profile_dir)

    # -- frames -------------------------------------------------------------
    def record_frames(self, rounds, frame: MetricsFrame) -> None:
        """Store one drained stack of frames (host numpy, leading axis
        ``len(rounds)``) and mirror a ``metrics`` record to the sink."""
        rounds = np.asarray(rounds, np.int64).reshape(-1)
        frame = MetricsFrame(*(np.asarray(l) for l in frame))
        self.frames.append((rounds, frame))
        if self.sink is not None:
            rec = {"type": "metrics", "rounds": rounds.tolist()}
            for name, leaf in zip(MetricsFrame._fields, frame):
                rec[name] = np.asarray(leaf, np.float64).tolist()
            self.sink.emit(rec)

    def frames_table(self) -> dict:
        """Every recorded frame, concatenated: ``{"round": [m], field:
        [m, ...]}`` across every run this ``Obs`` observed."""
        return self._frames_table(self.frames)

    def run_frames_table(self) -> dict:
        """:meth:`frames_table` of the run begun last: what health
        judges."""
        return self._frames_table(self.frames[self._frames_mark:])

    @staticmethod
    def _frames_table(frames) -> dict:
        if not frames:
            return {"round": np.zeros((0,), np.int64),
                    **{f: np.zeros((0,)) for f in MetricsFrame._fields}}
        out = {"round": np.concatenate([r for r, _ in frames])}
        for i, name in enumerate(MetricsFrame._fields):
            out[name] = np.concatenate(
                [np.atleast_1d(f[i]) if f[i].ndim == 0 else f[i]
                 for _, f in frames])
        return out

    # -- eval frames --------------------------------------------------------
    def record_eval(self, frame: EvalFrame) -> None:
        """Store one eval's fairness frame and mirror a ``type: "eval"``
        record to the sink."""
        self.eval_frames.append(frame)
        if self.sink is not None:
            self.sink.emit(frame_record(frame))

    def eval_table(self) -> dict:
        """Every recorded eval frame as aligned columns."""
        return _eval_table(self.eval_frames)

    def run_eval_table(self) -> dict:
        """:meth:`eval_table` of the run begun last."""
        return _eval_table(self.eval_frames[self._evals_mark:])
