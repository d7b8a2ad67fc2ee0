"""``run_experiment(net=...)`` of the port on the CPU: both drivers under
every netsim preset, against the reference's loop and against each other.

* Against the reference's ``engine=False`` loop, with the reference's
  draws and netsim uniforms (``torch_caps.JaxDraws``): the five algorithms
  under ``edge-v2`` (bursty links, tiers and async stale gossip at once),
  FACADE and EL under ``edge-churn``, FACADE under ``core-edge``. Bytes,
  rounds and cluster ids exact, simulated seconds within 1e-6 relative,
  accuracies, fair accuracy, DP, EO and the tier columns within 0.1 (the
  reference's precedent across layouts, ``tests/test_mesh.py``).
* The port against itself, where nothing is loose (``torch.equal`` on
  every parameter leaf, ``==`` on every history, bytes and seconds
  included): the engine, serialized and pipelined, against the loop under
  each of the nine presets for the five algorithms; ``preset("ideal")``
  against ``net=None`` (the trajectory); ``async_gossip=True,
  max_staleness=0`` against the synchronous run; a run killed at its
  third segment dispatch and resumed against the uninterrupted one under
  ``edge-v2``; a two-cell ``run_sweep`` with a preset against fresh
  ``run_experiment`` calls."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.core import runner as ref_runner
from repro.netsim import node_tiers as ref_node_tiers
from repro.obs.evalframe import compute_eval_frame as ref_eval_frame
from repro_torch import checkpoint
from repro_torch.configs import facade_paper
from repro_torch.core import runner
from repro_torch.data import synthetic
from repro_torch.netsim import PRESETS, NetworkConfig
from repro_torch.obs import compute_eval_frame, tiers_of
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


@pytest.fixture(scope="module")
def ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8, seed=3)
    return synthetic.make_clustered_data(spec, (3, 1), ("rot0", "rot180"))


def _kw(algo, **more):
    return {**KW, **EXTRA.get(algo, {}), **more}


def _net(name, **over):
    return NetworkConfig.preset(name, **over)


@pytest.mark.parametrize("algo,preset", [
    *((a, "edge-v2") for a in runner.ALGOS),
    ("facade", "edge-churn"), ("el", "edge-churn"), ("facade", "core-edge"),
])
def test_run_matches_the_reference_loop(ds, algo, preset):
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    kw = _kw(algo)
    want = ref_runner.run_experiment(algo, rcfg, ds, engine=False,
                                     net=ref_net(_net(preset)),
                                     **{k: v for k, v in kw.items()
                                        if k != "device"})
    got = runner.run_experiment(algo, CFG, ds, draws=JaxDraws(kw["seed"]),
                                net=_net(preset), **kw)
    assert got.comm.rounds == want.comm.rounds
    assert got.comm.bytes == want.comm.bytes                 # exact
    np.testing.assert_allclose(got.comm.seconds, want.comm.seconds,
                               rtol=1e-6)
    assert got.comm.seconds[-1] > 0
    assert len(got.cluster_history) == len(want.cluster_history)
    for (r1, c1), (r2, c2) in zip(got.cluster_history,
                                  want.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, np.asarray(c2))
    for (_, a), (_, b) in zip(got.acc_per_cluster, want.acc_per_cluster,
                              strict=True):
        np.testing.assert_allclose(a, b, atol=TOL)
    assert abs(got.dp - want.dp) <= TOL and abs(got.eo - want.eo) <= TOL
    for f, g in zip(got.eval_frames, want.eval_frames, strict=True):
        assert f.round == g.round and f.cluster_churn == g.cluster_churn
        for col in ("mean_acc", "fair_acc", "acc_core", "acc_edge",
                    "tier_gap"):
            assert abs(getattr(f, col) - getattr(g, col)) <= TOL, col


@pytest.mark.parametrize("name", ["core-edge", "edge-v2", "edge-churn"])
def test_tiers_split_the_eval_frame_as_the_references(name):
    """The tier vector from the reference's uniforms, and the frame's
    ``acc_core``/``acc_edge``/``tier_gap`` from it, exactly the
    reference's for the same per-node accuracies."""
    n, net = 16, _net(name)
    tiers = tiers_of(net, n, JaxDraws(0))
    want_tiers = (np.zeros(n, np.float32) if net.classes is None else
                  np.asarray(ref_node_tiers(ref_net(net), n), np.float32))
    np.testing.assert_array_equal(tiers, want_tiers)
    if net.classes is not None:
        assert 0 < tiers.sum() < n
    node_acc = np.random.default_rng(5).random(n)
    args = (4, [0.5, 0.75], (0, 1), [np.zeros(8, int)] * 2,
            [np.zeros(8, int)] * 2, node_acc, 4)
    got = compute_eval_frame(*args, mean_acc=0.6, tiers=tiers)
    want = ref_eval_frame(*args, mean_acc=0.6, tiers=want_tiers)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_engine_equals_the_loop_under_every_preset(ds, preset):
    """Five algorithms, 5 rounds with an eval every 2 (two segments and a
    partial one): the engine, serialized and pipelined, is the loop's run
    bit for bit, simulated seconds included."""
    for algo in runner.ALGOS:
        kw = _kw(algo, rounds=5, net=_net(preset))
        loop = runner.run_experiment(algo, CFG, ds, engine=False, **kw)
        assert_same_run(runner.run_experiment(algo, CFG, ds, **kw), loop)
        assert_same_run(runner.run_experiment(algo, CFG, ds, pipeline=True,
                                              **kw), loop)
        assert all(s >= 0 for s in np.diff([0.0] + loop.comm.seconds))


def test_ideal_reproduces_the_ideal_medium(ds):
    """``preset("ideal")`` runs the netsim path with all-ones masks: the
    trajectory of ``net=None`` (parameters, accuracies, cluster ids);
    only the accounting differs (the drawn edges, which multi-edges can
    leave below the nominal count, and simulated seconds)."""
    for algo in runner.ALGOS:
        base = runner.run_experiment(algo, CFG, ds, **_kw(algo))
        ideal = runner.run_experiment(algo, CFG, ds, net=_net("ideal"),
                                      **_kw(algo))
        for x, y in zip(tree_leaves(base.models), tree_leaves(ideal.models),
                        strict=True):
            assert torch.equal(x, y)
        assert base.acc_per_cluster == ideal.acc_per_cluster
        assert [(r, c.tolist()) for r, c in base.cluster_history] == \
            [(r, c.tolist()) for r, c in ideal.cluster_history]
        assert base.comm.seconds[-1] == 0.0 < ideal.comm.seconds[-1]
        # every drawn edge delivers; DAC symmetrises its graph, so its
        # delivered edges may outnumber the nominal n * degree
        assert all(0 < b and (b <= a or algo == "dac") for a, b in zip(
            np.diff([0.0] + base.comm.bytes),
            np.diff([0.0] + ideal.comm.bytes)))


@pytest.mark.parametrize("algo", runner.ALGOS)
def test_async_zero_staleness_is_the_sync_run(ds, algo):
    """``async_gossip=True, max_staleness=0``: every straggler publishes
    fresh state every round, so the run is the synchronous one bit for
    bit, bytes and seconds included, on both drivers."""
    sync = _net("edge-churn")
    asy = dataclasses.replace(sync, async_gossip=True, max_staleness=0)
    for engine in (True, False):
        a = runner.run_experiment(algo, CFG, ds, engine=engine, net=sync,
                                  **_kw(algo))
        b = runner.run_experiment(algo, CFG, ds, engine=engine, net=asy,
                                  **_kw(algo))
        assert_same_run(b, a)
    assert a.comm.seconds[-1] > 0


@pytest.mark.parametrize("algo", runner.ALGOS)
def test_kill_and_resume_under_edge_v2(ds, tmp_path, monkeypatch, algo):
    """Pipelined with a checkpoint, killed at the third segment dispatch
    and resumed, against the uninterrupted serialized run: the same run
    and the same final checkpoint, which holds the channel and the gossip
    buffer."""
    kw = _kw(algo, rounds=6, net=_net("edge-v2"),
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
    net = checkpoint.load(whole)[0]["net"]
    assert set(net) == {"chan", "gossip"}
    assert net["chan"].shape == (ds.n_nodes, ds.n_nodes)
    with pytest.raises(ValueError, match="fingerprint"):
        runner.run_experiment(algo, CFG, ds, ckpt=whole,
                              **{**kw, "net": _net("edge-churn")})


def test_sweep_with_a_net_preset(ds, tmp_path):
    """Two cells, one with a preset name and one with a config, over two
    seeds with a ``ckpt_dir``: each seed's run is a fresh
    ``run_experiment(net=...)`` call's bit for bit, the summary carries the
    simulated seconds, and a rerun skips both cells."""
    churn = _net("edge-churn", seed=3)

    def kwargs(algo):
        return {k: v for k, v in _kw(algo).items()
                if k not in ("seed", "rounds")}

    cells = [SweepCell("facade-v2", "facade", CFG, ds, 4, net="edge-v2",
                       kwargs=kwargs("facade")),
             SweepCell("el-churn", "el", CFG, ds, 4, net=churn,
                       kwargs=kwargs("el"))]
    sweep = run_sweep(cells, (0, 1), ckpt_dir=tmp_path, targets=(0.0,))
    for c, net in zip(sweep.cells, (_net("edge-v2"), churn)):
        assert c.error is None
        for seed, res in zip((0, 1), c.results):
            fresh = runner.run_experiment(
                c.cell.algo, CFG, ds, rounds=4, seed=seed, net=net,
                **c.cell.kwargs)
            assert_same_run(res, fresh)
        assert c.summary["sim_seconds"]["mean"] > 0
    assert sweep.to_json()["cells"]["facade-v2"]["net"] == "edge-v2"
    assert sweep.to_json()["cells"]["el-churn"]["net"] == "edge-churn"
    again = run_sweep(cells, (0, 1), ckpt_dir=tmp_path, targets=(0.0,))
    assert all(c.skipped for c in again.cells)
