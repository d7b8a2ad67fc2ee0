"""The port's run telemetry (``repro_torch.obs``) on the CPU, against the
reference's ``repro.obs`` and against the port's own run without it.

* ``compute_frame`` against the reference's on the same numpy inputs,
  with every gate on and off: the six count fields (``cluster_switches``,
  ``delivered_edges``, ``stale_hist``, ``crashed``, ``corrupted``,
  ``quarantined``) exact, the norms, ``inclusion`` (a mean) and the tier
  bytes within 1e-5 relative (float32 sums and means in another order
  than XLA's).
* An enabled ``Obs`` never perturbs a run: for the five algorithms, with
  no ``net``, under ``edge-v2`` with ``reset`` faults and under an
  adaptive policy on ``core-edge``, the loop, the engine and the
  pipelined, checkpointed engine with ``Obs(ObsConfig())`` are the
  ``obs=None`` run bit for bit, and their frames equal each other bit for
  bit; the same for FACADE and EL under ``None``, ``async-edge`` and
  ``edge-v2``.
* The port's frames against the reference's ``engine=False`` loop
  (``torch_caps.JaxDraws``): FACADE and EL under ``edge-v2`` with crashes,
  ``reset`` restarts and NaN corruption, and under ``reliability`` on
  ``core-edge``; counts exact, the rest within 1e-5.
* ``ObsConfig`` validation, every field forking ``EngineSpec`` and the
  host-side settings not; tracer nesting and rollup and a run's spans and
  events; JSONL and manifest round trips; ``maybe_profile``; kill and
  resume with frame sidecars; ``run_sweep(obs=)`` setting
  ``CellResult.health``."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import netsim as ref_netsim
from repro import obs as ref_obs
from repro.configs import facade_paper as ref_configs
from repro.core import runner as ref_runner
from repro_torch.configs import facade_paper
from repro_torch.core import runner
from repro_torch.core.cache import EngineCache, EngineSpec
from repro_torch.data import synthetic
from repro_torch.netsim import GossipState, NetworkConfig, RoundConditions
from repro_torch.obs import (FRAME_FIELDS, JsonlSink, Obs, ObsConfig,
                             RunManifest, Tracer, compute_frame, frame_row,
                             frame_width, frames_of_rows, maybe_profile,
                             read_jsonl)
from repro_torch.resil import FaultConfig
from repro_torch.sweep import SweepCell, run_sweep
from repro_torch.topo import TopoConfig
from test_torch_netsim import ref_net
from test_torch_resume import _killed_at_third_dispatch, assert_same_run
from test_torch_topo import ref_topo_cfg
from torch_caps import JaxDraws

torch.set_num_threads(1)
CFG = facade_paper.lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=3, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=1, seed=0, device="cpu")
EXTRA = {"facade": {"head_jitter": 0.05}}
COUNTS = ("cluster_switches", "delivered_edges", "stale_hist", "crashed",
          "corrupted", "quarantined")
NORMS = ("update_norm", "param_norm", "inclusion", "bytes_core",
         "bytes_edge")
REL = 1e-5
FAULTS = FaultConfig(crash_rate=0.4, restart_rate=0.6, corrupt_rate=0.3,
                     corrupt_mode="nan", restart_mode="reset")
ADAPTIVE = TopoConfig(policy="reliability", min_inclusion=0.2, decay=0.7)
SETTINGS = {"ideal": {},
            "faults": {"net": NetworkConfig.preset("edge-v2",
                                                   faults=FAULTS)},
            "topo": {"net": NetworkConfig.preset("core-edge"),
                     "topo": ADAPTIVE}}


@pytest.fixture(scope="module")
def tiny_ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8, seed=3)
    return synthetic.make_clustered_data(spec, cluster_sizes=(3, 1),
                                         transforms=("rot0", "rot180"))


def _kw(algo, **more):
    return {**KW, **EXTRA.get(algo, {}), **more}


def _assert_tables_equal(a: dict, b: dict):
    assert set(a) == set(b) == {"round"} | set(FRAME_FIELDS)
    for f in a:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _assert_matches_reference(got: dict, want: dict):
    np.testing.assert_array_equal(got["round"], want["round"])
    for f in COUNTS:
        np.testing.assert_array_equal(got[f], np.asarray(want[f]),
                                      err_msg=f)
    for f in NORMS:
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=REL,
                                   atol=0, err_msg=f)


# ------------------------------------------------------ compute_frame --
def _frame_inputs(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)

    def mix():
        return {"w": rng.standard_normal((n, 3, 4)).astype(np.float32),
                "b": rng.standard_normal((n, 5)).astype(np.float32),
                "cluster_id": rng.integers(0, 2, (n,)).astype(np.int32)}

    adj = (rng.random((n, n)) < 0.5).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    adj[2] = 0.0                                   # an excluded node
    bit = lambda p: (rng.random(n) < p).astype(np.float32)  # noqa: E731
    return {"prev": mix(), "new": mix(),
            "prev_cid": rng.integers(0, 2, (n,)).astype(np.int32),
            "new_cid": rng.integers(0, 2, (n,)).astype(np.int32),
            "adj": adj, "payload": 12345,
            "quarantined": np.asarray(2.0, np.float32),
            "edge_mask": adj, "active": bit(0.8), "straggler": bit(0.3),
            "stale": bit(0.4), "crashed": bit(0.3), "corrupt": bit(0.3),
            "age": rng.integers(0, 7, (n,)).astype(np.int32),
            "tiers": bit(0.5), "n": n}


FRAME_CASES = {
    "all": (ObsConfig(), {}),
    "norms_off": (ObsConfig(norms=False), {}),
    "comm_off": (ObsConfig(comm=False), {}),
    "switches_off": (ObsConfig(switches=False), {}),
    "faults_off": (ObsConfig(faults=False), {}),
    "one_bin": (ObsConfig(staleness_bins=1), {}),
    "seven_bins": (ObsConfig(staleness_bins=7), {}),
    "no_net": (ObsConfig(), {"conds": False, "gossip": False}),
    "sync_no_faults": (ObsConfig(), {"stale": False, "faults": False,
                                     "gossip": False}),
    "no_cid": (ObsConfig(), {"cid": False}),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_compute_frame_matches_the_reference(case):
    import jax.numpy as jnp
    cfg, off = FRAME_CASES[case]
    x = _frame_inputs(7)
    n, T = x["n"], torch.from_numpy

    def conds_of(mod, cast):
        if off.get("conds") is False:
            return None
        keep = off.get("faults") is not False
        return mod.RoundConditions(
            edge_mask=cast(x["edge_mask"]), active=cast(x["active"]),
            straggler=cast(x["straggler"]),
            stale=None if off.get("stale") is False else cast(x["stale"]),
            crashed=cast(x["crashed"]) if keep else None,
            corrupt=cast(x["corrupt"]) if keep else None)

    def gossip_of(mod, cast):
        if off.get("gossip") is False:
            return None
        return mod.GossipState(published=None, age=cast(x["age"]))

    def info_of(cast):
        info = {"adj_eff": cast(x["adj"]), "payload_bytes": x["payload"]}
        if off.get("faults") is not False:
            info["quarantined"] = cast(x["quarantined"])
        return info

    cid = off.get("cid") is not False
    got = compute_frame(
        cfg, n, T(x["tiers"]), {k: T(v) for k, v in x["prev"].items()},
        {k: T(v) for k, v in x["new"].items()},
        T(x["prev_cid"]) if cid else None, T(x["new_cid"]) if cid else None,
        info_of(T), conds_of(_PortMods, T), gossip_of(_PortMods, T))
    want = ref_obs.compute_frame(
        ref_obs.ObsConfig(**dataclasses.asdict(cfg)), n,
        jnp.asarray(x["tiers"]), x["prev"], x["new"],
        jnp.asarray(x["prev_cid"]) if cid else None,
        jnp.asarray(x["new_cid"]) if cid else None, info_of(jnp.asarray),
        conds_of(ref_netsim, jnp.asarray), gossip_of(ref_netsim,
                                                     jnp.asarray))
    for name, g, w in zip(FRAME_FIELDS, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape, name
        if name in NORMS:
            np.testing.assert_allclose(g, w, rtol=REL, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the packed row round-trips through the host unpacking
    row = frame_row(got)
    assert row.shape == (frame_width(cfg),) and row.dtype == torch.float32
    back = frames_of_rows(row[None].numpy(), cfg)
    for name, g, b in zip(FRAME_FIELDS, got, back):
        np.testing.assert_array_equal(b[0], g.numpy(), err_msg=name)


class _PortMods:
    RoundConditions = RoundConditions
    GossipState = GossipState


# ------------------------------------------- telemetry is pure, both ways --
@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("algo", runner.ALGOS)
def test_obs_never_perturbs_the_run(tiny_ds, tmp_path, algo, setting):
    """``obs=None`` against a fully enabled ``Obs`` on the loop, the
    engine and the pipelined, checkpointed engine: the same run bit for
    bit, and frames equal across the three drivers."""
    kw = _kw(algo, **SETTINGS[setting])
    ref = runner.run_experiment(algo, CFG, tiny_ds, **kw)
    tables, verdicts = [], []
    for i, drive in enumerate(({"engine": False}, {},
                               {"pipeline": True,
                                "ckpt": str(tmp_path / "run.npz")})):
        obs = Obs(ObsConfig(), jsonl=tmp_path / f"{i}.jsonl",
                  out_dir=tmp_path / f"{i}")
        got = runner.run_experiment(algo, CFG, tiny_ds, obs=obs,
                                    **drive, **kw)
        assert_same_run(got, ref)
        assert got.eval_frames == ref.eval_frames
        table = obs.frames_table()
        assert table["round"].tolist() == [1, 2, 3]
        tables.append(table)
        et = obs.eval_table()
        assert et["round"].tolist() == [1, 2, 3]
        assert et["dp"][-1] == got.dp and et["eo"][-1] == got.eo
        assert len(obs.manifests) == 1
        verdicts.append(obs.manifests[0].health)
        if algo != "facade":
            np.testing.assert_array_equal(table["cluster_switches"], 0.0)
    _assert_tables_equal(tables[1], tables[0])
    _assert_tables_equal(tables[2], tables[0])
    assert verdicts[1] == verdicts[2] == verdicts[0]
    if setting != "faults":
        assert verdicts[0]["verdict"] == "ok"
    else:
        t = tables[0]
        assert t["crashed"].sum() > 0 and t["corrupted"].sum() > 0


@pytest.mark.parametrize("preset", [None, "async-edge", "edge-v2"])
@pytest.mark.parametrize("algo", ["facade", "el"])
def test_engine_frames_equal_the_loops(tiny_ds, algo, preset):
    net = NetworkConfig.preset(preset) if preset else None
    tables = []
    for drive in ({"engine": False}, {}, {"pipeline": True}):
        obs = Obs(ObsConfig())
        runner.run_experiment(algo, CFG, tiny_ds, net=net, obs=obs,
                              **drive, **_kw(algo))
        tables.append(obs.frames_table())
    _assert_tables_equal(tables[1], tables[0])
    _assert_tables_equal(tables[2], tables[0])
    t = tables[0]
    np.testing.assert_array_equal(t["stale_hist"].sum(1), tiny_ds.n_nodes)
    if preset == "async-edge":
        assert t["stale_hist"][:, 1:].sum() > 0


# ------------------------------------------------- against the reference --
@pytest.mark.parametrize("setting", ["faults", "topo"])
@pytest.mark.parametrize("algo", ["facade", "el"])
def test_frames_match_the_reference_loop(tiny_ds, algo, setting):
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    kw, more = _kw(algo), SETTINGS[setting]
    ref = ref_obs.Obs(ref_obs.ObsConfig())
    ref_runner.run_experiment(
        algo, rcfg, tiny_ds, engine=False, net=ref_net(more["net"]),
        topo=ref_topo_cfg(more["topo"]) if "topo" in more else None,
        obs=ref, **{k: v for k, v in kw.items() if k != "device"})
    obs = Obs(ObsConfig())
    runner.run_experiment(algo, CFG, tiny_ds, draws=JaxDraws(kw["seed"]),
                          obs=obs, **more, **kw)
    got, want = obs.frames_table(), ref.frames_table()
    _assert_matches_reference(got, want)
    if setting == "faults":
        for f in ("crashed", "corrupted", "quarantined"):
            assert got[f].sum() > 0, f
    else:
        assert got["bytes_edge"].sum() > 0 and got["bytes_core"].sum() > 0


# ---------------------------------------------------------- frame schema --
def test_gated_off_fields_are_zero_not_absent(tiny_ds):
    cfg = ObsConfig(norms=False, comm=False, switches=False,
                    staleness_bins=2)
    obs = Obs(cfg)
    runner.run_experiment("facade", CFG, tiny_ds, obs=obs, **_kw("facade"))
    t = obs.frames_table()
    assert set(t) == {"round"} | set(FRAME_FIELDS)
    for f in ("update_norm", "param_norm", "cluster_switches",
              "delivered_edges", "inclusion", "bytes_core", "bytes_edge"):
        np.testing.assert_array_equal(t[f], 0.0, err_msg=f)
    assert t["stale_hist"].shape == (3, 2)


def test_frames_table_concats_across_runs_and_starts_empty(tiny_ds):
    empty = Obs(config=None).frames_table()
    assert empty["round"].shape == (0,)
    assert all(empty[f].shape[0] == 0 for f in FRAME_FIELDS)
    obs = Obs(ObsConfig())
    runner.run_experiment("el", CFG, tiny_ds, obs=obs, **KW)
    runner.run_experiment("el", CFG, tiny_ds, obs=obs, **{**KW, "seed": 1})
    t = obs.frames_table()
    assert t["round"].tolist() == [1, 2, 3, 1, 2, 3]
    assert obs.run_frames_table()["round"].tolist() == [1, 2, 3]
    assert [m.name for m in obs.manifests] == ["el-seed0", "el-seed1"]
    assert all(t[f].shape[0] == 6 for f in FRAME_FIELDS)


# ------------------------------------------------------------ cache key --
def _spec(obs):
    return EngineSpec(algo="facade", cfg=CFG, n=4, k=2, degree=2,
                      local_steps=2, batch_size=4, lr=0.05,
                      device=torch.device("cpu"), obs=obs)


def test_obsconfig_validation():
    with pytest.raises(ValueError, match="staleness_bins"):
        ObsConfig(staleness_bins=0)
    assert frame_width(ObsConfig(staleness_bins=3)) == 13


_PERTURB = {"norms": lambda v: not v, "comm": lambda v: not v,
            "switches": lambda v: not v, "staleness_bins": lambda v: v + 1,
            "faults": lambda v: not v}


def test_perturb_covers_every_obsconfig_field():
    assert {f.name for f in dataclasses.fields(ObsConfig)} == set(_PERTURB)
    assert set(_PERTURB) == {f.name for f in dataclasses.fields(
        ref_obs.ObsConfig)}


@pytest.mark.parametrize("field", sorted(_PERTURB))
def test_every_obsconfig_field_forks_the_cache_key(field):
    base = _spec(ObsConfig())
    assert base != _spec(None) and base == _spec(ObsConfig())
    mutated = _spec(dataclasses.replace(
        ObsConfig(), **{field: _PERTURB[field](getattr(ObsConfig(),
                                                       field))}))
    assert mutated != base and hash(mutated) != hash(base)


def test_host_side_settings_never_fork_the_key(tiny_ds, tmp_path):
    cache = EngineCache()
    runner.run_experiment("el", CFG, tiny_ds, cache=cache,
                          obs=Obs(ObsConfig(), jsonl=tmp_path / "a.jsonl"),
                          **KW)
    runner.run_experiment("el", CFG, tiny_ds, cache=cache,
                          obs=Obs(ObsConfig(), out_dir=tmp_path,
                                  health=None), **KW)
    runner.run_experiment("el", CFG, tiny_ds, cache=cache,
                          obs=Obs(ObsConfig()), **KW)
    assert cache.stats()["entries"] == 1 and cache.hits == 2
    assert cache.compile_count == 2          # one round program, one eval
    # an Obs without a config (spans only) shares the obs=None entry
    runner.run_experiment("el", CFG, tiny_ds, cache=cache, **KW)
    runner.run_experiment("el", CFG, tiny_ds, cache=cache,
                          obs=Obs(config=None), **KW)
    assert cache.stats()["entries"] == 2


# -------------------------------------------------------------- tracing --
def test_tracer_nesting_and_rollup(tmp_path):
    sink = JsonlSink(tmp_path / "t.jsonl")
    tr = Tracer(sink=sink)
    with tr.span("outer"):
        with tr.span("inner"):
            tr.event("tick", k=1)
        with tr.span("inner"):
            pass
    sink.close()
    inner = [s for s in tr.spans if s["name"] == "inner"]
    outer = [s for s in tr.spans if s["name"] == "outer"]
    assert [s["parent"] for s in inner] == ["outer", "outer"]
    assert all(s["depth"] == 1 for s in inner)
    assert outer[0]["parent"] is None and outer[0]["depth"] == 0
    assert outer[0]["dur_s"] >= max(s["dur_s"] for s in inner)
    roll = tr.rollup()
    assert roll["spans"]["inner"]["count"] == 2
    assert roll["events"] == {"tick": 1}
    assert len(read_jsonl(sink.path)) == 4


@pytest.mark.parametrize("drive", ["engine", "loop", "pipeline_ckpt"])
def test_run_spans_and_events(tiny_ds, tmp_path, drive):
    kw = {"engine": {}, "loop": {"engine": False},
          "pipeline_ckpt": {"pipeline": True,
                            "ckpt": str(tmp_path / "c.npz")}}[drive]
    obs = Obs(ObsConfig(), jsonl=tmp_path / "run.jsonl")
    runner.run_experiment("facade", CFG, tiny_ds, obs=obs, **kw,
                          **_kw("facade"))
    roll = obs.tracer.rollup()
    want = {"cache.entry", "eval", "run"} | (
        set() if drive == "loop" else {"compile", "dispatch", "drain"}) | (
        {"ckpt.save"} if drive == "pipeline_ckpt" else set())
    assert set(roll["spans"]) == want
    assert roll["spans"]["eval"]["count"] == 3
    if drive != "loop":
        assert roll["spans"]["compile"]["count"] == 1
        assert roll["spans"]["dispatch"]["count"] == 2
        assert roll["spans"]["drain"]["count"] == 3
    assert roll["events"] == {"run.begin": 1, "cache.miss": 1,
                              "evaluator.build": 1, "run.end": 1}
    spans = {s["name"]: s for s in obs.tracer.spans}
    assert spans["run"]["parent"] is None
    assert spans["eval"]["parent"] == "run"
    recs = read_jsonl(tmp_path / "run.jsonl")
    assert [r["rounds"] for r in recs if r["type"] == "metrics"] == (
        [[1], [2], [3]])
    assert [r["round"] for r in recs if r["type"] == "eval"] == [1, 2, 3]
    assert {"span", "event", "metrics", "eval"} == {r["type"] for r in recs}


def test_maybe_profile_writes_a_trace_and_never_fails_quietly(tmp_path,
                                                              monkeypatch):
    with maybe_profile(None):
        pass
    with maybe_profile(tmp_path / "prof"):
        torch.ones(4).sum()
    assert len(list((tmp_path / "prof").glob("trace-*.json"))) == 1

    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr("torch.profiler.profile", Broken)
    with pytest.raises(RuntimeError, match="no profiler"):
        with maybe_profile(tmp_path / "prof2"):
            pass


# --------------------------------------------------------- disk records --
def test_jsonl_and_manifest_round_trip(tiny_ds, tmp_path):
    obs = Obs(ObsConfig(), jsonl=tmp_path / "run.jsonl", out_dir=tmp_path)
    runner.run_experiment("dac", CFG, tiny_ds, obs=obs, **KW)
    obs.sink.close()
    man = obs.manifests[-1]
    back = RunManifest.load(tmp_path / "manifest_dac-seed0.json")
    assert back == man
    assert man.kind == "run" and man.settings["jsonl"] == str(
        tmp_path / "run.jsonl")
    assert man.settings["obs"] == repr(ObsConfig())
    assert man.cache["entries"] == 1 and "run" in man.timing["spans"]
    # the reference's reader takes the port's manifest and JSONL
    assert ref_obs.RunManifest.load(tmp_path / "manifest_dac-seed0.json"
                                    ).health == man.health
    recs = read_jsonl(tmp_path / "run.jsonl")
    assert recs == ref_obs.read_jsonl(tmp_path / "run.jsonl")
    metrics = [r for r in recs if r["type"] == "metrics"]
    t = obs.frames_table()
    for f in FRAME_FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(r[f]) for r in metrics]).astype(
                np.float32), t[f], err_msg=f)
    assert json.loads(json.dumps(man.health)) == man.health


# ---------------------------------------------------------- kill/resume --
@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "piped"])
def test_kill_and_resume_replays_the_frame_sidecars(tiny_ds, tmp_path,
                                                    monkeypatch, pipeline):
    kw = _kw("facade", rounds=6, eval_every=2, warmup_rounds=1,
             net=NetworkConfig.preset("edge-v2", faults=FAULTS))
    whole = Obs(ObsConfig())
    want = runner.run_experiment("facade", CFG, tiny_ds, obs=whole, **kw)
    ck = str(tmp_path / "killed.npz")
    _killed_at_third_dispatch(monkeypatch, lambda: runner.run_experiment(
        "facade", CFG, tiny_ds, obs=Obs(ObsConfig()), ckpt=ck,
        pipeline=pipeline, **kw))
    assert (tmp_path / "killed.npz.frames-0.npz").exists()
    obs = Obs(ObsConfig())
    got = runner.run_experiment("facade", CFG, tiny_ds, obs=obs, ckpt=ck,
                                pipeline=pipeline, **kw)
    assert_same_run(got, want)
    _assert_tables_equal(obs.frames_table(), whole.frames_table())
    assert obs.frames_table()["round"].tolist() == list(range(1, 7))
    assert obs.eval_frames == whole.eval_frames
    assert obs.tracer.rollup()["events"]["ckpt.resume"] == 1
    # a finished checkpoint replays every frame and runs nothing
    again = Obs(ObsConfig())
    runner.run_experiment("facade", CFG, tiny_ds, obs=again, ckpt=ck, **kw)
    _assert_tables_equal(again.frames_table(), whole.frames_table())


# ------------------------------------------------------------ run_sweep --
def test_run_sweep_sets_cell_health(tiny_ds, tmp_path):
    kw = {k: v for k, v in KW.items() if k not in ("rounds", "seed")}
    cells = [SweepCell(name=a, algo=a, cfg=CFG, dataset=tiny_ds, rounds=2,
                       kwargs=kw) for a in ("facade", "el", "no-such-algo")]
    cells[-1].name = "bad"
    obs = Obs(ObsConfig(), jsonl=tmp_path / "sweep.jsonl")
    json_path = tmp_path / "sweep.json"
    sweep = run_sweep(cells, (0, 1), json_path=json_path, obs=obs)
    for name in ("facade", "el"):
        health = sweep.cell(name).health
        assert health["verdict"] == "ok"
        assert set(health["runs"]) == {f"{name}-seed0", f"{name}-seed1"}
    assert sweep.cell("bad").error is not None
    assert sweep.cell("bad").health is None
    assert len(obs.manifests) == 4
    roll = obs.tracer.rollup()
    assert roll["spans"]["sweep.cell"]["count"] == 3    # the bad one's too
    assert roll["events"]["sweep.cell_failed"] == 1
    out = json.loads(json_path.read_text())
    assert out["cells"]["facade"]["health"]["verdict"] == "ok"
    man = RunManifest.load(json_path.with_suffix(".json.manifest.json"))
    assert man.health == {"verdict": "ok",
                          "cells": {"facade": "ok", "el": "ok"}}
    assert "sweep.cell" in man.timing["spans"]
