"""Sinks: a JSONL event log and the run manifest written next to results.

The port's own copy of ``repro.obs.sink`` (no JAX), in the same on-disk
formats: one line = one JSON record (:class:`JsonlSink`, replayed with
:func:`read_jsonl`), and :class:`RunManifest`, the "what exactly ran"
record (the static config fingerprint, the run settings, a timing rollup
and the cache stats). The manifest names the framework that wrote it
(``torch_version`` here, ``jax_version`` in the reference), and
:meth:`RunManifest.load` drops keys it does not know, so each package
reads the other's manifests.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import time
import warnings
from typing import Any

import torch


def fingerprint(obj: Any) -> str:
    """Stable content hash of any JSON-ish object (non-serializable
    leaves fall back to ``repr`` via ``default=repr``)."""
    text = json.dumps(obj, sort_keys=True, default=repr)
    return hashlib.sha1(text.encode()).hexdigest()


class JsonlSink:
    """Append-structured JSONL writer. Opens lazily, flushes per record
    (a crashed run keeps every event up to the crash), and works as a
    context manager. ``mode="w"`` (default) starts a fresh log per sink;
    pass ``mode="a"`` to extend an existing one."""

    def __init__(self, path, mode: str = "w"):
        self.path = pathlib.Path(path)
        self._mode = mode
        self._fh = None
        self.n_emitted = 0

    def emit(self, record: dict) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open(self._mode)
        self._fh.write(json.dumps(record, default=repr) + "\n")
        self._fh.flush()
        self.n_emitted += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path) -> list[dict]:
    """Load a JSONL event log back into a list of dicts (empty when the
    file was never written: a sink with zero events opens no file).

    A hard kill mid-``write`` leaves a truncated FINAL line; that line
    is skipped with a warning so a crashed run's trace still replays.
    A malformed line anywhere else means real corruption and raises.
    """
    p = pathlib.Path(path)
    if not p.exists():
        return []
    lines = [(i, ln) for i, ln in enumerate(p.read_text().splitlines(), 1)
             if ln.strip()]
    records = []
    for pos, (lineno, ln) in enumerate(lines):
        try:
            records.append(json.loads(ln))
        except json.JSONDecodeError:
            if pos == len(lines) - 1:
                warnings.warn(
                    f"{p}: skipping truncated final line {lineno} "
                    "(interrupted write)", RuntimeWarning, stacklevel=2)
                break
            raise
    return records


@dataclasses.dataclass
class RunManifest:
    """What ran, keyed how, and where the time went.

    Every field carries a default and :meth:`load` drops unknown keys,
    so old manifests read under a grown schema (missing keys default),
    new manifests read under an old one (extra keys ignored), and the
    reference's manifests (``jax_version``) read here.
    """
    kind: str = "run"           # run | sweep | sweep-cell | bench | serve
    name: str = ""              # e.g. "facade-seed0"
    fingerprint: str = ""       # sha1 over the static spec/config repr
    spec: str = ""              # repr of the EngineSpec / config object
    settings: dict = dataclasses.field(default_factory=dict)
    timing: dict = dataclasses.field(default_factory=dict)
    cache: "dict | None" = None   # EngineCache.stats() snapshot
    health: "dict | None" = None  # HealthReport.to_json() verdict
    created_unix: float = 0.0
    torch_version: str = ""

    @classmethod
    def build(cls, kind: str, name: str, spec: Any, settings: dict,
              timing: "dict | None" = None,
              cache: "dict | None" = None,
              health: "dict | None" = None) -> "RunManifest":
        return cls(kind=kind, name=name,
                   fingerprint=fingerprint(repr(spec)), spec=repr(spec),
                   settings=settings, timing=timing or {}, cache=cache,
                   health=health, created_unix=time.time(),
                   torch_version=torch.__version__)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=2, default=repr))
        return path

    @classmethod
    def load(cls, path) -> "RunManifest":
        data = json.loads(pathlib.Path(path).read_text())
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


def bench_stamp(name: str, payload: dict) -> dict:
    """The manifest block a benchmark stamps into its JSON output: a
    content fingerprint of the payload plus enough environment to tell
    two benchmark runs apart."""
    return {"name": name, "fingerprint": fingerprint(payload),
            "torch_version": torch.__version__, "created_unix": time.time()}
