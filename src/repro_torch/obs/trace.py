"""Host-side span tracer for the training and serving drivers.

The port of ``repro.obs.trace``, with the same record schema, so a JSONL
trace the port writes reads like the reference's. :class:`Tracer` keeps
nested spans (``run``, ``compile``, ``dispatch``, ``drain``, ``eval``,
``ckpt.save`` in ``run_experiment``; ``prefill`` and ``decode`` in
serving) with their host-clock start and duration, point events (cache
hits and misses, health rules, SLO summaries), an aggregate
:meth:`Tracer.rollup`, and an optional mirror of every record into a
:class:`~repro_torch.obs.sink.JsonlSink`.

A span is host Python around the launch boundary: it never enters a
captured graph and adds no host sync, so tracing changes no round and no
``EngineSpec`` key. What a span measures follows from that. Launches are
asynchronous, so a ``dispatch`` span holds the host's draws and the
enqueueing of a segment's replays, and the ``drain`` span after it the
wait for the segment's copy to the host, which absorbs the card's work.
A ``compile`` span holds a segment whose round is captured first (its
eager warm-up round and the capture). Under ``run_experiment(pipeline=
True)`` segment t+1 is dispatched before t is drained, so ``drain``
shrinks to the residual wait; compare the ``run`` span instead.

:func:`maybe_profile` is the device-trace hook: ``torch.profiler`` with
a Chrome trace written under the directory given.
"""
from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Any

import torch


class Tracer:
    """Nested span tracer with an optional JSONL sink.

    ``span(name, **attrs)`` is a context manager; spans nest through an
    explicit stack, so every record carries its ``parent`` and ``depth``.
    ``event(name, **attrs)`` records a point event. All records are kept
    in memory (``spans`` / ``events``) and mirrored to ``sink`` when one
    is attached."""

    def __init__(self, sink=None, clock=time.perf_counter):
        self.sink = sink
        self.clock = clock
        self.spans: list[dict] = []
        self.events: list[dict] = []
        self._stack: list[str] = []
        self._t0 = clock()

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        t0 = self.clock()
        parent = self._stack[-1] if self._stack else None
        self._stack.append(name)
        try:
            yield self
        finally:
            self._stack.pop()
            rec = {"type": "span", "name": name, "parent": parent,
                   "depth": len(self._stack), "t0_s": t0 - self._t0,
                   "dur_s": self.clock() - t0, **attrs}
            self.spans.append(rec)
            if self.sink is not None:
                self.sink.emit(rec)

    def event(self, name: str, **attrs: Any) -> dict:
        rec = {"type": "event", "name": name,
               "t_s": self.clock() - self._t0, **attrs}
        self.events.append(rec)
        if self.sink is not None:
            self.sink.emit(rec)
        return rec

    def rollup(self) -> dict:
        """Timing per span name, ``{name: {count, total_s}}``, and the
        event counts: the ``RunManifest`` timing payload."""
        out: dict[str, dict] = {}
        for rec in self.spans:
            slot = out.setdefault(rec["name"],
                                  {"count": 0, "total_s": 0.0})
            slot["count"] += 1
            slot["total_s"] += rec["dur_s"]
        ev: dict[str, int] = {}
        for rec in self.events:
            ev[rec["name"]] = ev.get(rec["name"], 0) + 1
        return {"spans": out, "events": ev}


def span(tracer, name: str, **attrs):
    """``tracer.span(name, **attrs)``, or a no-op without a tracer: the
    drivers never require an ``Obs``."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **attrs)


@contextlib.contextmanager
def _profiled(profile_dir: pathlib.Path):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profile_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(profile_dir / f"trace-{time.time_ns()}"
                                 ".json"))


def maybe_profile(profile_dir):
    """The device-trace hook: a context manager that runs its block under
    ``torch.profiler`` (CPU, and CUDA where a card is present) and writes
    a Chrome trace (``trace-<ns>.json``) under ``profile_dir``. Without a
    directory it is a no-op. With one, a profiler that fails raises: it
    never does nothing quietly."""
    if not profile_dir:
        return contextlib.nullcontext()
    return _profiled(pathlib.Path(profile_dir))
