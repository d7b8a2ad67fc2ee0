"""The pipelined driver and checkpoint/resume on the card: pipelined
against serialized for the five algorithms, the event-based drain (a
segment's drain returns while the next segment still runs), and a run
killed at its third segment dispatch and resumed.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. No tolerance: on one device the two
drivers, and a resumed run and an uninterrupted one, give the same run bit
for bit, so every parameter and checkpoint leaf is held with
``torch.equal`` and every history with ``==``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch.configs.facade_paper import lenet
from repro_torch.core import engine, facade
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
# FACADE's first round in its warmup phase: segments [0, 1) [1, 4) [4, 8)
# [8, 10), both of its rounds captured
KW = dict(rounds=10, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=4, seed=0)
EXTRA = {"facade": {"head_jitter": 0.05, "warmup_rounds": 1}}


def _data():
    return make_clustered_data(
        SynthSpec(n_classes=4, image_size=16, samples_per_class=8,
                  test_per_class=8, seed=3), (3, 1), ("rot0", "rot180"))


def _run(algo, ds, dev, **kw):
    return run_experiment(algo, CFG, ds, device=dev,
                          **{**KW, **EXTRA.get(algo, {}), **kw})


class Killed(Exception):
    pass


def assert_same_run(a, b):
    for x, y in zip(tree_leaves(a.models), tree_leaves(b.models),
                    strict=True):
        assert x.device.type == "cuda" and torch.equal(x, y)
    assert a.acc_per_cluster == b.acc_per_cluster
    assert a.fair_acc == b.fair_acc and (a.dp, a.eo) == (b.dp, b.eo)
    for col in ("rounds", "bytes", "seconds", "acc", "evaled"):
        assert getattr(a.comm, col) == getattr(b.comm, col), col
    assert len(a.cluster_history) == len(b.cluster_history)
    for (r1, c1), (r2, c2) in zip(a.cluster_history, b.cluster_history):
        assert r1 == r2 and np.array_equal(c1, c2)
    assert a.eval_frames == b.eval_frames


@requires_cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_pipelined_equals_serialized_on_the_card(cuda_device, algo):
    """Each driver through a fresh cache: the same run, and K1's count the
    same (the rounds plus one warm-up call a captured round); with
    ``target_acc`` 0.0 the pipelined run also replays the segment it
    dispatched past the eval that hit."""
    ds = _data()
    graphs = 2 if algo == "facade" else 1
    for target in (None, 0.0):
        counts = []
        runs = []
        for pipeline in (False, True):
            head_losses.launches = 0
            runs.append(_run(algo, ds, cuda_device, pipeline=pipeline,
                             target_acc=target, cache=EngineCache()))
            counts.append(head_losses.launches)
        assert_same_run(*runs)
        if algo != "facade":
            assert counts == [0, 0]
        elif target is None:
            assert counts == [10 + WARMUP_ROUNDS * graphs] * 2
        else:   # stopped at round 4; the pipelined run also ran [4, 8)
            assert counts == [4 + WARMUP_ROUNDS * graphs,
                              8 + WARMUP_ROUNDS * graphs]


@requires_cuda
def test_a_drain_waits_for_its_segment_and_not_the_next(cuda_device):
    ds = _data()
    n, k, deg = ds.n_nodes, 2, 2
    binding = make_binding(CFG)
    fcfg = facade.FacadeConfig(n_nodes=n, k=k, degree=deg, lr=0.05)
    eng = SegmentEngine(
        functools.partial(facade.facade_round, fcfg, binding), n=n,
        local_steps=2, batch_size=4, device=cuda_device, track_cluster=True,
        topology_draw="perms", degree=deg)
    draws = TorchDraws(0)
    params, heads_k = draws.facade_init(binding, k, 0.05)
    carry = eng.init_carry(init_facade_state(
        binding, n, k, params=params, heads_k=heads_k, device=cuda_device))
    train_x, train_y = eng.place_data(ds)
    carry, _ = eng.run_segment(carry, 0, 2, train_x, train_y, draws)
    carry, first = eng.dispatch_segment(carry, 2, 2, train_x, train_y, draws)
    carry, second = eng.dispatch_segment(carry, 4, 60, train_x, train_y,
                                         draws)
    got = eng.drain(first)
    assert not second["end"].query()     # segment t+1 still on the card
    assert got["cluster_id"].device.type == "cpu"
    assert got["cluster_id"].shape == (2, n)
    assert eng.drain(second)["cluster_id"].shape == (60, n)
    assert carry.state.round == 64 and eng.compile_count == 1


@requires_cuda
@pytest.mark.parametrize("algo", ["facade", "dac"])
def test_kill_and_resume_on_the_card(cuda_device, tmp_path, monkeypatch,
                                     algo):
    """Pipelined with a checkpoint, killed at the third segment dispatch
    and resumed through a fresh cache, against an uninterrupted serialized
    run: the same run and the same final checkpoint. The resumed run's K1
    count is its replayed rounds plus one warm-up call a captured round."""
    ds = _data()
    whole = str(tmp_path / "whole.npz")
    want = _run(algo, ds, cuda_device, ckpt=whole)
    ck = str(tmp_path / "killed.npz")
    orig = SegmentEngine.dispatch_segment
    calls = []

    def killer(self, *a, **k):
        if len(calls) == 2:
            raise Killed
        calls.append(1)
        return orig(self, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(engine.SegmentEngine, "dispatch_segment", killer)
        with pytest.raises(Killed):
            _run(algo, ds, cuda_device, ckpt=ck, pipeline=True)
    meta = checkpoint.load(ck)[1]
    assert (meta["next_segment"], meta["finished"]) == (1, False)
    head_losses.launches = 0
    got = _run(algo, ds, cuda_device, ckpt=ck, pipeline=True,
               cache=EngineCache())
    # FACADE resumes at round 1 with its main round; DAC at round 4
    assert head_losses.launches == (9 + WARMUP_ROUNDS if algo == "facade"
                                    else 0)
    assert_same_run(want, got)
    (pa, ma), (pb, mb) = checkpoint.load(whole), checkpoint.load(ck)
    assert ma == mb and ma["finished"]
    for name in ("carry", "draws"):
        for x, y in zip(tree_leaves(pa[name]), tree_leaves(pb[name]),
                        strict=True):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _run(algo, ds, cuda_device, ckpt=ck, seed=1)
