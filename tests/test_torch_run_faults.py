"""``run_experiment(net=NetworkConfig(..., faults=FaultConfig(...)))`` of
the port on the CPU: node crashes, restarts, payload corruption and the
robust guard on both drivers, against the reference's loop and against
each other.

* Against the reference's ``engine=False`` loop (its engine and loop part
  for EL under faults, a known gap of the reference), with the reference's
  draws, netsim uniforms and fault draws (``torch_caps.JaxDraws``): the
  five algorithms under ``edge-v2`` with crashes and NaN corruption (the
  guard on), FACADE and DAC under ``reset`` restarts, FACADE in noise
  mode. Rounds and bytes exact, simulated seconds within 1e-6 relative,
  cluster ids exact (in noise mode too: the noise is the reference's own,
  leaf for leaf, and the corrupted heads clip the same way), accuracies,
  DP and EO within 0.1 (the repo's precedent).
* The port against itself, bit for bit (``torch.equal`` on every
  parameter leaf, ``==`` on every history): the engine, serialized and
  pipelined, against the loop for the five algorithms under each fault
  mode; ``FaultConfig()`` and ``FaultConfig(robust=False)`` against the
  fault-free run; a ``reset`` run killed at its third segment dispatch
  and resumed; a ``run_sweep`` cell with faults against a fresh call.
* Honest accounting and the guard at run level: every node down costs 0
  bytes and 0 seconds; a NaN storm leaves the guarded run's parameters
  finite and poisons the unguarded one's."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.core import runner as ref_runner
from repro_torch import checkpoint
from repro_torch.configs import facade_paper
from repro_torch.core import runner
from repro_torch.data import synthetic
from repro_torch.netsim import NetworkConfig
from repro_torch.resil import FaultConfig
from repro_torch.sweep import SweepCell, run_sweep
from repro_torch.tree import tree_leaves
from test_torch_netsim import ref_net
from test_torch_resume import (_killed_at_third_dispatch, assert_same_run,
                               assert_same_checkpoint)
from torch_caps import JaxDraws

torch.set_num_threads(1)
TOL = 0.1
CFG = facade_paper.lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=4, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=2, seed=0, device="cpu")
EXTRA = {"facade": {"head_jitter": 0.05}}
FAULTS = {
    "nan": FaultConfig(crash_rate=0.3, restart_rate=0.5, corrupt_rate=0.3,
                       corrupt_mode="nan"),
    "reset": FaultConfig(crash_rate=0.4, restart_rate=0.6,
                         restart_mode="reset"),
    "noise": FaultConfig(crash_rate=0.3, restart_rate=0.5,
                         corrupt_rate=0.3),
}


@pytest.fixture(scope="module")
def ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8, seed=3)
    return synthetic.make_clustered_data(spec, (3, 1), ("rot0", "rot180"))


def _kw(algo, **more):
    return {**KW, **EXTRA.get(algo, {}), **more}


def _net(faults, preset="edge-v2"):
    return NetworkConfig.preset(preset, faults=faults)


@pytest.mark.parametrize("algo,mode", [
    *((a, "nan") for a in runner.ALGOS),
    ("facade", "reset"), ("dac", "reset"), ("facade", "noise"),
])
def test_run_matches_the_reference_loop(ds, algo, mode):
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    kw, net = _kw(algo), _net(FAULTS[mode])
    want = ref_runner.run_experiment(algo, rcfg, ds, engine=False,
                                     net=ref_net(net),
                                     **{k: v for k, v in kw.items()
                                        if k != "device"})
    got = runner.run_experiment(algo, CFG, ds, draws=JaxDraws(kw["seed"]),
                                net=net, **kw)
    assert got.comm.rounds == want.comm.rounds
    assert got.comm.bytes == want.comm.bytes                 # exact
    np.testing.assert_allclose(got.comm.seconds, want.comm.seconds,
                               rtol=1e-6)
    assert len(got.cluster_history) == len(want.cluster_history)
    for (r1, c1), (r2, c2) in zip(got.cluster_history,
                                  want.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, np.asarray(c2))
    for (_, a), (_, b) in zip(got.acc_per_cluster, want.acc_per_cluster,
                              strict=True):
        np.testing.assert_allclose(a, b, atol=TOL)
    assert abs(got.dp - want.dp) <= TOL and abs(got.eo - want.eo) <= TOL
    assert all(bool(torch.isfinite(leaf).all())
               for leaf in tree_leaves(got.models))


@pytest.mark.parametrize("mode", sorted(FAULTS))
def test_engine_equals_the_loop_under_faults(ds, mode):
    """Five algorithms, 5 rounds with an eval every 2: the engine,
    serialized and pipelined, is the loop's run bit for bit, and the
    faults changed the run (bytes or accuracies differ from the
    fault-free one)."""
    for algo in runner.ALGOS:
        kw = _kw(algo, rounds=5, net=_net(FAULTS[mode]))
        loop = runner.run_experiment(algo, CFG, ds, engine=False, **kw)
        assert_same_run(runner.run_experiment(algo, CFG, ds, **kw), loop)
        assert_same_run(runner.run_experiment(algo, CFG, ds, pipeline=True,
                                              **kw), loop)
        free = runner.run_experiment(algo, CFG, ds,
                                     **{**kw, "net": _net(None)})
        assert (free.comm.bytes != loop.comm.bytes
                or free.acc_per_cluster != loop.acc_per_cluster)


@pytest.mark.parametrize("algo", runner.ALGOS)
def test_zero_rate_faults_are_the_fault_free_run(ds, algo):
    """``FaultConfig()`` (every rate zero) and ``FaultConfig(robust=
    False)`` run the fault-free ``edge-v2`` trajectory bit for bit, on
    both drivers."""
    for engine in (True, False):
        base = runner.run_experiment(algo, CFG, ds, engine=engine,
                                     net=_net(None), **_kw(algo))
        for fc in (FaultConfig(), FaultConfig(robust=False)):
            assert_same_run(runner.run_experiment(
                algo, CFG, ds, engine=engine, net=_net(fc), **_kw(algo)),
                base)


@pytest.mark.parametrize("algo", ["facade", "dac"])
def test_kill_and_resume_under_reset(ds, tmp_path, monkeypatch, algo):
    """``reset`` restarts, pipelined with a checkpoint, killed at the
    third segment dispatch and resumed, against the uninterrupted
    serialized run: the same run and the same final checkpoint, which
    holds the crash chain and its round-0 copy of the state."""
    kw = _kw(algo, rounds=6, net=_net(FAULTS["reset"]),
             **({"warmup_rounds": 1} if algo == "facade" else {}))
    whole = str(tmp_path / "whole.npz")
    want = runner.run_experiment(algo, CFG, ds, ckpt=whole, **kw)
    ck = str(tmp_path / "killed.npz")
    _killed_at_third_dispatch(monkeypatch, lambda: runner.run_experiment(
        algo, CFG, ds, ckpt=ck, pipeline=True, **kw))
    assert os.path.exists(ck)
    got = runner.run_experiment(algo, CFG, ds, ckpt=ck, pipeline=True, **kw)
    assert_same_run(got, want)
    assert_same_checkpoint(ck, whole)
    fault = checkpoint.load(whole)[0]["net"]["fault"]
    assert set(fault) == {"down", "init"}
    assert fault["down"].shape == (ds.n_nodes,)
    assert set(fault["init"]) == set(checkpoint.load(whole)[0]["carry"]) - {
        "round"}
    with pytest.raises(ValueError, match="fingerprint"):
        runner.run_experiment(algo, CFG, ds, ckpt=whole,
                              **{**kw, "net": _net(FAULTS["nan"])})


def test_sweep_cell_with_faults(ds, tmp_path):
    """A ``run_sweep`` cell whose net has faults, over two seeds: each
    seed's run is a fresh ``run_experiment`` call's bit for bit."""
    net = _net(FAULTS["nan"])
    kwargs = {k: v for k, v in _kw("facade").items()
              if k not in ("seed", "rounds")}
    sweep = run_sweep([SweepCell("facade-faults", "facade", CFG, ds, 4,
                                 net=net, kwargs=kwargs)], (0, 1),
                      ckpt_dir=tmp_path)
    cell = sweep.cells[0]
    assert cell.error is None
    for seed, res in zip((0, 1), cell.results, strict=True):
        assert_same_run(res, runner.run_experiment(
            "facade", CFG, ds, rounds=4, seed=seed, net=net, **kwargs))


def test_faults_must_be_a_fault_config(ds):
    with pytest.raises(TypeError, match="resil.FaultConfig"):
        runner.run_experiment("el", CFG, ds,
                              net=_net(object(), "edge-churn"), **_kw("el"))


def test_crashed_nodes_cost_zero_bytes_and_seconds(ds):
    """``crash_rate=1, restart_rate=0``: every node is down from round 1
    on, so no byte moves and the clock never waits, on both drivers."""
    net = _net(FaultConfig(crash_rate=1.0, restart_rate=0.0), "edge-churn")
    for engine in (True, False):
        r = runner.run_experiment("el", CFG, ds, engine=engine, net=net,
                                  **_kw("el"))
        assert np.diff([0.0] + r.comm.bytes).tolist() == [0.0] * 4
        assert np.diff([0.0] + r.comm.seconds).tolist() == [0.0] * 4


@pytest.mark.parametrize("algo", ["facade", "dpsgd"])
def test_guard_keeps_the_parameters_finite_under_a_nan_storm(ds, algo):
    """20% NaN corruption: the guarded run never lets a non-finite value
    into the parameters; the unguarded run is poisoned."""
    storm = FaultConfig(corrupt_rate=0.2, corrupt_mode="nan")
    guarded = runner.run_experiment(algo, CFG, ds, net=_net(storm),
                                    **_kw(algo))
    unguarded = runner.run_experiment(
        algo, CFG, ds, net=_net(dataclasses.replace(storm, robust=False)),
        **_kw(algo))
    assert all(bool(torch.isfinite(leaf).all())
               for leaf in tree_leaves(guarded.models))
    assert not all(bool(torch.isfinite(leaf).all())
                   for leaf in tree_leaves(unguarded.models))
