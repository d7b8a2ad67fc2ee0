"""The adaptive topology policy on the card: the captured adaptive round
(the policy's sampler inside the CUDA graph, its EWMAs in the engine's
static buffers, the drawn graph's bytes drained) against the eager loop,
K1's launches in FACADE's replayed adaptive rounds, and the fairness
floor measured on the card.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. On one device the engine equals the
loop bit for bit, so every parameter leaf is held with ``torch.equal``
and every history, the simulated seconds included, with ``==``.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch import topo
from repro_torch.core.engine import WARMUP_ROUNDS
from repro_torch.core.runner import ALGOS, run_experiment
from repro_torch.kernels.head_select import head_losses
from repro_torch.netsim import NetworkConfig
from repro_torch.topo import TopoConfig
from test_torch_netsim_cuda import CFG, KW, _data, _same_run
from torch_caps import cuda_device, requires_cuda  # noqa: F401

ADAPTIVE = TopoConfig(policy="reliability", min_inclusion=0.2, decay=0.7)


@requires_cuda
@pytest.mark.parametrize("preset", ["core-edge", None],
                         ids=["core-edge", "ideal-medium"])
@pytest.mark.parametrize("algo", ALGOS)
def test_engine_equals_the_loop_under_a_policy(cuda_device, algo, preset):
    """rounds 5, eval every 2; FACADE with a warmup round (both of its
    rounds captured). Serialized and pipelined against the loop; K1's
    count is the warm-up calls before each capture plus one a replayed
    round; without ``net`` each round's drained bytes are a whole number
    of the nominal round's payloads, at most its ``n * degree``."""
    ds = _data()
    net = None if preset is None else NetworkConfig.preset(preset)
    kw = dict(KW, device=cuda_device, net=net, topo=ADAPTIVE)
    if algo == "facade":
        kw.update(head_jitter=0.05, warmup_rounds=1)
    loop = run_experiment(algo, CFG, ds, engine=False, **kw)
    head_losses.launches = 0
    eng = run_experiment(algo, CFG, ds, **kw)
    want = KW["rounds"] + 2 * WARMUP_ROUNDS if algo == "facade" else 0
    assert head_losses.launches == want
    _same_run(eng, loop)
    _same_run(run_experiment(algo, CFG, ds, pipeline=True, **kw), loop)
    if preset is None:
        nominal = run_experiment(algo, CFG, ds, **dict(kw, topo=None))
        payload = nominal.comm.bytes[0] / (ds.n_nodes * KW["degree"])
        edges = np.diff([0.0] + eng.comm.bytes) / payload
        assert np.array_equal(edges, np.rint(edges))
        cap = ds.n_nodes * KW["degree"] * (2 if algo == "dac" else 1)
        assert (edges > 0).all() and (edges <= cap).all()


@requires_cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_uniform_policy_is_the_run_without_a_policy(cuda_device, algo):
    ds = _data()
    kw = dict(KW, device=cuda_device, net=NetworkConfig.preset("core-edge"))
    _same_run(run_experiment(algo, CFG, ds, topo=TopoConfig(), **kw),
              run_experiment(algo, CFG, ds, **kw))


@requires_cuda
def test_the_floor_holds_on_the_card(cuda_device):
    cfg = TopoConfig(policy="reliability", min_inclusion=0.3)
    st = topo.inclusion_stats(cfg, NetworkConfig.preset("core-edge"), n=10,
                              rounds=300, degree=4, device=cuda_device)
    sigma = np.sqrt(0.3 * 0.7 / 300)
    assert st["symmetric"] and st["binary"]
    assert st["mean_edges"] <= st["edge_budget"]
    assert st["participation"].min() >= 0.3 - 3 * sigma
