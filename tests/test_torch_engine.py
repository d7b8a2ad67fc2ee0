"""The port's segment engine (``core/engine.py``) on the CPU: its segment
plan against the reference's, its runs against the port's per-round loop
(exactly: the same closures on the same draws), FACADE's warmup->main
boundary, the ``target_acc`` exit, ``CommLog.record_bulk``, and its runs
against the reference's ``engine=True`` from the reference's draws
(``torch_caps.JaxDraws``).

Tolerances against the reference, as ``tests/test_torch_runner.py`` holds
the port's loop against the reference's: accuracies, fair accuracy, DP and
EO within 0.1 (the reference's precedent across layouts,
``tests/test_mesh.py``); bytes per round and the FACADE cluster history
exact (FACADE decorrelates its heads, ``head_jitter``, so no selection is a
near-tie). Against the port's own loop nothing is loose: ``torch.equal`` on
every parameter leaf, ``==`` on every history."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro.comm.accounting import CommLog as RefCommLog
from repro.configs import facade_paper as ref_configs
from repro.core import engine as ref_engine
from repro.core import runner as ref_runner
from repro_torch.comm import CommLog
from repro_torch.configs import facade_paper
from repro_torch.core import engine, runner
from repro_torch.core.cache import EngineCache
from repro_torch.core.bindings import make_binding
from repro_torch.data import pipeline, synthetic
from repro_torch.tree import tree_leaves
from torch_caps import JaxDraws

torch.set_num_threads(1)
TOL = 0.1
CFG = facade_paper.lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=5, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=2, seed=0, device="cpu")
JITTER = {"facade": {"head_jitter": 0.05}}


@pytest.fixture(scope="module")
def ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8, seed=3)
    return synthetic.make_clustered_data(spec, (3, 1), ("rot0", "rot180"))


def assert_same_run(a, b):
    """Two runs are one run: every parameter leaf and every history."""
    la, lb = tree_leaves(a.models), tree_leaves(b.models)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    assert a.acc_per_cluster == b.acc_per_cluster
    assert a.fair_acc == b.fair_acc
    assert a.final_acc == b.final_acc
    assert (a.dp, a.eo) == (b.dp, b.eo)
    assert a.comm.rounds == b.comm.rounds
    assert a.comm.bytes == b.comm.bytes                 # exact floats
    assert a.comm.evaled == b.comm.evaled
    assert a.comm.acc == b.comm.acc
    assert len(a.cluster_history) == len(b.cluster_history)
    for (r1, c1), (r2, c2) in zip(a.cluster_history, b.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, c2)
    assert [f.cluster_churn for f in a.eval_frames] == \
        [f.cluster_churn for f in b.eval_frames]


@pytest.mark.parametrize(
    "rounds,eval_every,warmup",
    list(itertools.product((0, 1, 5, 8, 10), (1, 3, 4), (0, 3))) +
    [(6, 4, 6), (6, 4, 9), (20, 20, 5)])
def test_segment_plan_equals_the_reference(rounds, eval_every, warmup):
    got = engine.segment_plan(rounds, eval_every, warmup)
    want = ref_engine.segment_plan(rounds, eval_every, warmup)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert sum(s.length for s in got) == rounds


@pytest.mark.parametrize("algo", runner.ALGOS)
def test_engine_equals_the_loop(ds, algo):
    """rounds 5, eval every 2: two full segments and a trailing partial
    one."""
    kw = {**KW, **JITTER.get(algo, {})}
    loop = runner.run_experiment(algo, CFG, ds, engine=False, **kw)
    eng = runner.run_experiment(algo, CFG, ds, **kw)
    assert_same_run(eng, loop)
    assert loop.comm.rounds == [1, 2, 3, 4, 5]
    assert loop.comm.evaled == [False, True, False, True, True]


@pytest.mark.parametrize("warmup,eval_every", [(3, 4), (2, 2), (6, 3)],
                         ids=["inside-a-span", "at-an-eval", "whole-run"])
def test_facade_warmup_boundary(ds, warmup, eval_every):
    """The warmup->main switch cuts a segment (FACADE's two round
    programs), at or between evals, or never (all rounds warmup)."""
    kw = {**KW, **JITTER["facade"], "rounds": 6, "eval_every": eval_every,
          "warmup_rounds": warmup}
    loop = runner.run_experiment("facade", CFG, ds, engine=False, **kw)
    cache = EngineCache()
    eng = runner.run_experiment("facade", CFG, ds, cache=cache, **kw)
    assert_same_run(eng, loop)
    assert cache.compile_count == (2 if warmup < 6 else 1) + 1
    # the warmup rounds report cluster 0 on every node
    for rnd, cid in eng.cluster_history[:warmup]:
        assert rnd <= warmup and not cid.any()


@pytest.mark.parametrize("algo", runner.ALGOS)
def test_target_acc_stops_at_the_same_round(ds, algo):
    """The first eval that reaches the target ends both runs there, and
    FACADE's cluster history stops a round before it, as the loop breaks
    before recording the eval round's ids."""
    kw = {**KW, **JITTER.get(algo, {}), "rounds": 8, "target_acc": 0.0}
    loop = runner.run_experiment(algo, CFG, ds, engine=False, **kw)
    eng = runner.run_experiment(algo, CFG, ds, **kw)
    assert_same_run(eng, loop)
    assert eng.comm.rounds == [1, 2]
    assert [r for r, _ in eng.cluster_history] == \
        ([1] if algo == "facade" else [])


def test_segment_engine_equals_a_hand_loop(ds):
    """``SegmentEngine`` driven directly, one segment over four rounds,
    against the same round closure called round by round on the same
    draws: every state leaf, the round counter, each round's bytes and
    cluster ids."""
    binding = make_binding(CFG)
    n, h, b, deg = ds.n_nodes, 2, 4, 2
    program = runner.algo_program("facade", binding, n, 2, degree=deg,
                                  lr=0.05, head_jitter=0.05)
    train_x, train_y = pipeline.place(ds, "cpu")
    draws = runner.TorchDraws(7)
    state = runner.algo_setup("facade", binding, draws, n, 2, degree=deg,
                              lr=0.05, head_jitter=0.05, device="cpu").state
    cids, rbs = [], []
    for _ in range(4):
        idx = draws.batch_indices(n, h, b, train_x.shape[1])
        state, info = program.round_fn(
            state, pipeline.sample_round_batches(idx, train_x, train_y),
            draws.perms(n, deg))
        cids.append(info["cluster_id"])
        rbs.append(info["round_bytes"])

    draws = runner.TorchDraws(7)
    eng = engine.SegmentEngine(program.round_fn, n=n, local_steps=h,
                               batch_size=b, device="cpu",
                               track_cluster=True, topology_draw="perms",
                               degree=deg)
    carry = eng.init_carry(program.setup(draws, torch.device("cpu")).state)
    carry, outs = eng.run_segment(carry, 0, 4, train_x, train_y, draws)
    assert carry.state.round == state.round == 4
    for f in ("cores", "heads", "cluster_id"):
        for x, y in zip(tree_leaves(getattr(state, f)),
                        tree_leaves(getattr(carry.state, f))):
            assert torch.equal(x, y)
    assert outs["round_bytes"].tolist() == rbs
    assert torch.equal(outs["cluster_id"], torch.stack(cids))
    assert eng.compile_count == 1
    with pytest.raises(ValueError, match="round 4"):
        eng.run_segment(carry, 0, 1, train_x, train_y, draws)


@pytest.mark.parametrize("algo", runner.ALGOS)
def test_engine_matches_the_reference_engine(ds, algo):
    """The port's engine against the reference's ``engine=True`` (its
    scan-fused segments, batches sampled inside the scan), fed the
    reference's draws."""
    kw = {**KW, **JITTER.get(algo, {})}
    kw.pop("device")
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    want = ref_runner.run_experiment(algo, rcfg, ds, engine=True, **kw)
    got = runner.run_experiment(algo, CFG, ds, device="cpu",
                                draws=JaxDraws(kw["seed"]), **kw)
    assert got.comm.rounds == want.comm.rounds
    assert got.comm.bytes == want.comm.bytes                 # exact
    assert got.comm.evaled == want.comm.evaled
    assert [r for r, _ in got.acc_per_cluster] == \
        [r for r, _ in want.acc_per_cluster]
    for (_, a), (_, b) in zip(got.acc_per_cluster, want.acc_per_cluster):
        np.testing.assert_allclose(a, b, atol=TOL)
    np.testing.assert_allclose([v for _, v in got.fair_acc],
                               [v for _, v in want.fair_acc], atol=TOL)
    assert abs(got.dp - want.dp) <= TOL and abs(got.eo - want.eo) <= TOL
    assert len(got.cluster_history) == len(want.cluster_history)
    for (r1, c1), (r2, c2) in zip(got.cluster_history,
                                  want.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, np.asarray(c2))


@pytest.mark.parametrize("base", [0.0, 1234.5])
def test_record_bulk_equals_per_round_record(base):
    """A segment's bytes recorded at once accumulate bit for bit as round
    by round, from an empty log or after an eval, as the reference's."""
    rb = np.random.default_rng(0).uniform(1e5, 1e9, 7)
    logs = [CommLog(), CommLog(), RefCommLog()]
    if base:
        for log in logs:
            log.record(1, base, 0.25)
    first = 2 if base else 1
    rounds = np.arange(first, first + rb.size)
    for r, v in zip(rounds, rb):
        logs[0].record(int(r), v)
    logs[1].record_bulk(rounds, rb)
    logs[2].record_bulk(rounds, rb)
    one, bulk, ref = logs
    assert bulk.bytes == one.bytes == ref.bytes
    assert bulk.rounds == one.rounds == ref.rounds
    assert bulk.acc == one.acc and bulk.evaled == one.evaled
    assert bulk.bytes_to_target(0.2) == (base if base else None)
    bulk.record_bulk([], [])
    assert bulk.bytes == one.bytes
    with pytest.raises(ValueError, match="equal length"):
        bulk.record_bulk([1, 2], [3.0])
