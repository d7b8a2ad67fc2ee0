"""The segment engine on the card: its CUDA-graph replays against the
per-round loop, and its refusal of a round that syncs with the host.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. No tolerance: on one device the engine
equals the loop bit for bit (the same closures on the same draws, TF32
off and cuDNN deterministic in both drivers), so every parameter leaf is
held with ``torch.equal`` and every history with ``==``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.facade_paper import lenet
from repro_torch.core import facade
from repro_torch.core.bindings import make_binding
from repro_torch.core.cache import EngineCache
from repro_torch.core.engine import WARMUP_ROUNDS, SegmentEngine
from repro_torch.core.runner import ALGOS, TorchDraws, run_experiment
from repro_torch.core.state import init_facade_state
from repro_torch.data.synthetic import SynthSpec, make_clustered_data
from repro_torch.kernels.head_select import head_losses
from repro_torch.tree import tree_leaves
from torch_caps import cuda_device, requires_cuda  # noqa: F401

CFG = lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=5, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=2, seed=0)


def _data():
    return make_clustered_data(
        SynthSpec(n_classes=4, image_size=16, samples_per_class=8,
                  test_per_class=8, seed=3), (3, 1), ("rot0", "rot180"))


@requires_cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_graph_engine_equals_the_loop(cuda_device, algo):
    """rounds 5, eval every 2 (a trailing partial segment); FACADE with a
    warmup round, so both of its rounds are captured. K1's count is what
    the card ran: the warm-up calls before each capture, then one a
    replayed round."""
    ds = _data()
    kw = dict(KW, device=cuda_device)
    if algo == "facade":
        kw.update(head_jitter=0.05, warmup_rounds=1)
    loop = run_experiment(algo, CFG, ds, engine=False, **kw)
    cache = EngineCache()
    head_losses.launches = 0
    eng = run_experiment(algo, CFG, ds, cache=cache, **kw)
    graphs = 2 if algo == "facade" else 1
    assert head_losses.launches == (
        KW["rounds"] + WARMUP_ROUNDS * graphs if algo == "facade" else 0)
    assert cache.compile_count == graphs + 1        # and the evaluator
    for a, b in zip(tree_leaves(loop.models), tree_leaves(eng.models)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert eng.acc_per_cluster == loop.acc_per_cluster
    assert eng.fair_acc == loop.fair_acc
    assert (eng.dp, eng.eo) == (loop.dp, loop.eo)
    assert eng.comm.rounds == loop.comm.rounds
    assert eng.comm.bytes == loop.comm.bytes
    assert eng.comm.evaled == loop.comm.evaled
    assert len(eng.cluster_history) == len(loop.cluster_history)
    for (r1, c1), (r2, c2) in zip(eng.cluster_history,
                                  loop.cluster_history):
        assert r1 == r2 and np.array_equal(c1, c2)
    again = run_experiment(algo, CFG, ds, cache=cache, **dict(kw, seed=1))
    assert cache.compile_count == graphs + 1        # flat on the 2nd run
    assert again.comm.bytes == eng.comm.bytes


@requires_cuda
def test_a_round_that_syncs_with_the_host_makes_the_engine_raise(
        cuda_device):
    ds = _data()
    n, k, deg = ds.n_nodes, 2, 2
    binding = make_binding(CFG)
    fcfg = facade.FacadeConfig(n_nodes=n, k=k, degree=deg, lr=0.05)

    def syncing_round(state, batches, perms):
        new, info = facade.facade_round(fcfg, binding, state, batches,
                                        perms)
        if info["selection_losses"].sum().item() < 0:     # a host sync
            raise AssertionError("negative losses")
        return new, info

    eng = SegmentEngine(syncing_round, n=n, local_steps=2, batch_size=4,
                        device=cuda_device, track_cluster=True,
                        topology_draw="perms", degree=deg)
    draws = TorchDraws(0)
    params, heads_k = draws.facade_init(binding, k, 0.05)
    carry = eng.init_carry(init_facade_state(
        binding, n, k, params=params, heads_k=heads_k, device=cuda_device))
    train_x, train_y = eng.place_data(ds)
    with pytest.raises(RuntimeError, match="syncing_round"):
        eng.run_segment(carry, 0, 2, train_x, train_y, draws)
    # the card is still usable, and a round that does not sync captures
    eng = SegmentEngine(
        functools.partial(facade.facade_round, fcfg, binding), n=n,
        local_steps=2, batch_size=4, device=cuda_device, track_cluster=True,
        topology_draw="perms", degree=deg)
    carry = eng.init_carry(init_facade_state(
        binding, n, k, params=params, heads_k=heads_k, device=cuda_device))
    train_x, train_y = eng.place_data(ds)
    carry, outs = eng.run_segment(carry, 0, 2, train_x, train_y, draws)
    assert eng.compile_count == 1 and outs["cluster_id"].shape == (2, n)
    assert carry.state.round == 2
    assert all(bool(torch.isfinite(l).all())
               for l in tree_leaves(carry.state.cores))
