"""The port's run records against the JAX package's, on the same inputs:
``obs/sink.py`` (``fingerprint``, ``JsonlSink`` and ``read_jsonl`` with
its truncated-last-line rule, ``RunManifest`` files read across the
packages, ``bench_stamp``) and ``comm/accounting.py`` (``CommLog``'s
bytes and simulated-seconds columns and its ``*_to_target`` queries).
Everything here is host arithmetic on equal inputs, so nothing is loose:
equal strings, equal dicts and ``==`` on every float column."""
from __future__ import annotations

import pathlib
import warnings

import numpy as np
import pytest
import torch

from repro.comm.accounting import CommLog as RefCommLog
from repro.obs import sink as ref_sink
from repro_torch.comm import CommLog
from repro_torch.obs import sink

torch.set_num_threads(1)

JSONISH = [
    {"spec": "EngineSpec(algo='facade', n=4)", "seed": 0, "rounds": 6,
     "target": repr(None)},
    {"b": [1, 2.5, None, True], "a": {"z": "x", "y": [{"k": 1e-300}]}},
    ["order", {"matters": 1}, ("tuple", 3)],
    {"obj": pathlib.Path("a/b"), "nan": float("nan"), "unicode": "µs"},
]


@pytest.mark.parametrize("obj", JSONISH, ids=range(len(JSONISH)))
def test_fingerprint_equals_the_references(obj):
    assert sink.fingerprint(obj) == ref_sink.fingerprint(obj)
    assert len(sink.fingerprint(obj)) == 40


def _write(path, lines):
    path.write_text("".join(line + "\n" for line in lines))


def test_jsonl_round_trip_and_the_truncated_last_line(tmp_path):
    path = tmp_path / "log.jsonl"
    records = [{"type": "span", "name": "eval", "round": r, "s": r * 0.5}
               for r in range(3)]
    with sink.JsonlSink(path) as s:
        for rec in records:
            s.emit(rec)
    assert s.n_emitted == 3
    assert sink.read_jsonl(path) == ref_sink.read_jsonl(path) == records
    assert sink.read_jsonl(tmp_path / "never.jsonl") == []
    # a hard kill mid-write leaves a truncated final line: skipped, warned
    text = path.read_text()
    path.write_text(text + '{"type": "span", "na')
    for read in (sink.read_jsonl, ref_sink.read_jsonl):
        with pytest.warns(RuntimeWarning, match="truncated final line 4"):
            assert read(path) == records
    # a corrupt line anywhere else is corruption: both raise
    _write(path, ['{"a": 1}', '{"b": ', '{"c": 3}'])
    for read in (sink.read_jsonl, ref_sink.read_jsonl):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(ValueError):
                read(path)


def test_jsonl_append_mode(tmp_path):
    path = tmp_path / "log.jsonl"
    with sink.JsonlSink(path) as s:
        s.emit({"i": 0})
    with sink.JsonlSink(path, mode="a") as s:
        s.emit({"i": 1})
    assert sink.read_jsonl(path) == [{"i": 0}, {"i": 1}]


def test_manifests_load_across_the_packages(tmp_path):
    settings = {"cell_fingerprint": "abc", "seeds": [0, 1]}
    ours = sink.RunManifest.build(kind="sweep-cell", name="facade",
                                  spec="CNNConfig(...)", settings=settings,
                                  cache={"compiles": 3})
    assert ours.torch_version == torch.__version__
    ref = ref_sink.RunManifest.build(kind="sweep-cell", name="facade",
                                     spec="CNNConfig(...)",
                                     settings=settings,
                                     cache={"compiles": 3})
    ours.save(tmp_path / "ours.json")
    ref.save(tmp_path / "ref.json")
    from_ref = sink.RunManifest.load(tmp_path / "ref.json")
    from_ours = ref_sink.RunManifest.load(tmp_path / "ours.json")
    for a, b in ((from_ref, ref), (from_ours, ours)):
        assert (a.kind, a.name, a.fingerprint, a.spec, a.settings,
                a.cache) == (b.kind, b.name, b.fingerprint, b.spec,
                             b.settings, b.cache)
    # the version key of the other package is dropped, its own defaults
    assert from_ref.torch_version == "" and from_ours.jax_version == ""
    assert ours.fingerprint == ref.fingerprint


def test_bench_stamp(tmp_path):
    payload = {"rounds_per_s": [22.5, 23.0], "cell": "facade"}
    stamp = sink.bench_stamp("engine", payload)
    assert stamp["fingerprint"] == ref_sink.bench_stamp(
        "engine", payload)["fingerprint"]
    assert stamp["name"] == "engine"
    assert stamp["torch_version"] == torch.__version__


def _commlog_ops(seed: int):
    """A random sequence of ``record`` / ``record_bulk`` calls: bytes and
    seconds per round, some rounds evaluated with an accuracy."""
    rng = np.random.default_rng(seed)
    ops, rnd = [], 0
    for _ in range(rng.integers(3, 8)):
        if rng.random() < 0.5:
            m = int(rng.integers(0, 5))
            ops.append(("bulk", np.arange(rnd + 1, rnd + 1 + m),
                        rng.uniform(1e5, 1e9, m),
                        None if rng.random() < 0.3
                        else rng.uniform(0.0, 30.0, m)))
            rnd += m
        else:
            rnd += 1
            acc = None if rng.random() < 0.3 else float(rng.uniform())
            ops.append(("one", rnd, float(rng.uniform(1e5, 1e9)), acc,
                        float(rng.uniform(0.0, 30.0))))
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_commlog_equals_the_references(seed):
    logs = (CommLog(), RefCommLog())
    for op in _commlog_ops(seed):
        for log in logs:
            if op[0] == "bulk":
                log.record_bulk(op[1], op[2], op[3])
            else:
                log.record(op[1], op[2], op[3], round_s=op[4])
    ours, ref = logs
    for col in ("rounds", "bytes", "seconds", "acc", "evaled"):
        assert getattr(ours, col) == getattr(ref, col), col
    for t in (0.0, 0.3, 0.6, 0.9, 1.1):
        assert ours.bytes_to_target(t) == ref.bytes_to_target(t)
        assert ours.seconds_to_target(t) == ref.seconds_to_target(t)
    assert ours.total_gb == ref.total_gb
    assert ours.total_hours == ref.total_hours


def test_an_empty_commlog_reaches_no_target():
    log = CommLog()
    assert log.bytes_to_target(0.0) is None
    assert log.seconds_to_target(0.0) is None
    assert (log.total_gb, log.total_hours) == (0.0, 0.0)
    log.record_bulk([1, 2], [3.0, 4.0])
    assert log.seconds == [0.0, 0.0] and log.bytes_to_target(0.0) is None
    with pytest.raises(ValueError, match="equal length"):
        log.record_bulk([1, 2], [3.0, 4.0], [1.0])
