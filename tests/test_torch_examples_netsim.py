"""``examples/torch_netsim_demo.py`` against the reference example's own
settings on the CPU: its seven networks are the ones
``examples/netsim_demo.py`` builds (the scripted bad day included), and
three of its runs at 4 rounds (eval every 2), through
``torch_caps.JaxDraws``, are the reference's ``run_experiment`` with the
reference example's settings: the bad day on ``wan``, the reliability
policy on ``edge-v2`` and the NaN corruption under the robust guard.
Bytes, rounds and simulated seconds exact, accuracies within 0.1 (the
reference's own precedent across layouts, ``tests/test_mesh.py``).
Cluster ids are not compared: the example, as the reference's, starts
from equal heads (``head_jitter`` 0), so round one's selections are
last-ulp ties that the two frameworks may break differently
(``test_torch_examples.py``'s quickstart case says the same).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
from repro.configs import facade_paper as ref_configs
from repro.core import runner as ref_runner
from repro.data import synthetic as ref_synthetic
from repro.netsim import BurstFailure, NetworkConfig, Partition
from repro.resil import FaultConfig
from repro.topo import TopoConfig
from test_torch_netsim import ref_net
from torch_caps import JaxDraws

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 0.1
FEW = dict(rounds=4, eval_every=2)
# the reference example's networks (examples/netsim_demo.py)
BAD_DAY = NetworkConfig.preset(
    "wan", events=(BurstFailure(start=12, duration=6, fraction=0.33),
                   Partition(start=24, duration=8, groups=2)))
EDGE_V2 = NetworkConfig.preset("edge-v2")
REF_SCENARIOS = {name: NetworkConfig.preset(name) for name in (
    "ideal", "edge-churn", "bursty-wan", "core-edge", "async-edge",
    "edge-v2")}
REF_SCENARIOS["wan+events"] = BAD_DAY


def _netsim_demo():
    path = REPO / "examples" / "torch_netsim_demo.py"
    spec = importlib.util.spec_from_file_location("torch_netsim_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def demo():
    ex = _netsim_demo()
    return ex, ex.run(device="cpu", draws=JaxDraws, **FEW)


def test_netsim_demo_builds_the_reference_networks():
    got = {name: ref_net(net)
           for name, net in _netsim_demo().scenarios().items()}
    assert got == REF_SCENARIOS


@pytest.mark.parametrize("case", ["wan+events", "reliability", "robust"])
def test_netsim_demo_runs_match_the_reference(demo, case):
    _, out = demo
    got, ref_kw = {
        "wan+events": (out["scenarios"]["wan+events"], dict(net=BAD_DAY)),
        "reliability": (out["reliability"], dict(
            net=EDGE_V2, topo=TopoConfig(policy="reliability",
                                         min_inclusion=0.25, decay=0.7))),
        "robust": (out["hostile"]["robust"][0], dict(
            net=dataclasses.replace(EDGE_V2, faults=FaultConfig(
                corrupt_rate=0.25, corrupt_mode="nan", robust=True)))),
    }[case]
    spec = ref_synthetic.SynthSpec(n_classes=4, image_size=16,
                                   samples_per_class=16, test_per_class=32,
                                   seed=3)
    ds = ref_synthetic.make_clustered_data(spec, (6, 2), ("rot0", "rot180"))
    want = ref_runner.run_experiment(
        "facade", ref_configs.lenet(smoke=True).replace(n_classes=4), ds,
        rounds=FEW["rounds"], k=2, degree=2, local_steps=4, batch_size=8,
        lr=0.05, eval_every=FEW["eval_every"], seed=0, engine=False,
        **ref_kw)
    assert got.comm.rounds == want.comm.rounds
    assert got.comm.bytes == want.comm.bytes                 # exact
    assert got.comm.seconds == want.comm.seconds             # exact
    assert got.comm.seconds[-1] > 0
    assert [r for r, _ in got.cluster_history] == \
        [r for r, _ in want.cluster_history]
    np.testing.assert_allclose(got.final_acc, want.final_acc, atol=TOL)
    assert abs(got.best_fair_acc() - want.best_fair_acc()) <= TOL
    assert np.isfinite(np.asarray(got.node_acc, float)).all()
