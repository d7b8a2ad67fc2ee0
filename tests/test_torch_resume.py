"""Checkpoint/resume and the pipelined driver of the port's
``run_experiment`` (``ckpt=``, ``pipeline=True``) on the CPU.

The port against itself, for the five algorithms (FACADE with a warmup
round, so both of its round programs): the pipelined driver against the
serialized one, also through a ``target_acc`` exit; a run killed at its
third segment dispatch and resumed from its checkpoint against the
uninterrupted run, on both drivers, with the port's own draws
(``TorchDraws``) and with the reference's (``torch_caps.JaxDraws``); a
finished checkpoint replayed by either driver; refused checkpoints.
Nothing is loose there: ``torch.equal`` on every parameter leaf and on
every leaf of the final checkpoints, ``==`` on every history.

The slice against the reference: FACADE and EL through ``JaxDraws``,
pipelined and killed then resumed, against the reference's
``run_experiment(..., pipeline=True, ckpt=...)``, at
``tests/test_torch_engine.py``'s tolerances (bytes, rounds and cluster
ids exact; accuracies, fair accuracy, DP and EO within 0.1)."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.core import runner as ref_runner
from repro_torch import checkpoint
from repro_torch.configs import facade_paper
from repro_torch.core import engine, runner
from repro_torch.data import synthetic
from repro_torch.tree import tree_leaves
from torch_caps import JaxDraws

torch.set_num_threads(1)
TOL = 0.1
CFG = facade_paper.lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=6, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=2, seed=0, device="cpu")
# FACADE decorrelates its heads (no near-tie selections) and spends its
# first round in the warmup phase: segments [0, 1) [1, 2) [2, 4) [4, 6)
EXTRA = {"facade": {"head_jitter": 0.05, "warmup_rounds": 1}}
DRAWS = {"torch": runner.TorchDraws, "jax": JaxDraws}


@pytest.fixture(scope="module")
def ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8, seed=3)
    return synthetic.make_clustered_data(spec, (3, 1), ("rot0", "rot180"))


def _kw(algo, **more):
    return {**KW, **EXTRA.get(algo, {}), **more}


def _run(algo, ds, draws="torch", **kw):
    kw = _kw(algo, **kw)
    return runner.run_experiment(algo, CFG, ds,
                                 draws=DRAWS[draws](kw["seed"]), **kw)


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
    np.testing.assert_array_equal(a.node_acc, b.node_acc)
    for col in ("rounds", "bytes", "seconds", "acc", "evaled"):
        assert getattr(a.comm, col) == getattr(b.comm, col), col
    assert len(a.cluster_history) == len(b.cluster_history)
    for (r1, c1), (r2, c2) in zip(a.cluster_history, b.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, c2)
    assert a.eval_frames == b.eval_frames


def assert_same_checkpoint(path_a, path_b):
    (pa, ma), (pb, mb) = checkpoint.load(path_a), checkpoint.load(path_b)
    assert ma == mb and ma["finished"]
    la, lb = tree_leaves(_as_dicts(pa)), tree_leaves(_as_dicts(pb))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x is None and y is None) or torch.equal(x, y)


def _as_dicts(tree):
    """A loaded checkpoint's lists as dicts, for ``tree_leaves``."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return tree


class Killed(Exception):
    pass


def _killed_at_third_dispatch(monkeypatch, call):
    """Run ``call`` with ``SegmentEngine.dispatch_segment`` raising at its
    third call (after one or two segments were checkpointed), then undo
    the patch."""
    orig = engine.SegmentEngine.dispatch_segment
    calls = []

    def killer(self, *a, **k):
        if len(calls) == 2:
            raise Killed
        calls.append(1)
        return orig(self, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(engine.SegmentEngine, "dispatch_segment", killer)
        with pytest.raises(Killed):
            call()


@pytest.mark.parametrize("target", [None, 0.0], ids=["full", "target"])
@pytest.mark.parametrize("algo", runner.ALGOS)
def test_pipelined_equals_serialized(ds, algo, target):
    """A target of 0.0 is reached at the first eval (round 2): the
    pipelined driver has dispatched the next segment by then and drops
    it, and its result keeps the models of the eval that hit."""
    a = _run(algo, ds, target_acc=target)
    b = _run(algo, ds, target_acc=target, pipeline=True)
    assert_same_run(a, b)
    assert a.comm.rounds[-1] == (2 if target is not None else 6)


@pytest.mark.parametrize("draws", ["torch", "jax"])
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serialized", "pipelined"])
@pytest.mark.parametrize("algo", runner.ALGOS)
def test_kill_and_resume_equals_the_uninterrupted_run(ds, tmp_path,
                                                      monkeypatch, algo,
                                                      pipeline, draws):
    whole = str(tmp_path / "whole.npz")
    want = _run(algo, ds, draws, ckpt=whole)
    ck = str(tmp_path / "killed.npz")
    _killed_at_third_dispatch(monkeypatch, lambda: _run(
        algo, ds, draws, ckpt=ck, pipeline=pipeline))
    meta = checkpoint.load(ck)[1]
    assert meta["next_segment"] == (1 if pipeline else 2)
    assert not meta["finished"]
    got = _run(algo, ds, draws, ckpt=ck, pipeline=pipeline)
    assert_same_run(want, got)
    assert_same_checkpoint(whole, ck)


@pytest.mark.parametrize("first,then", [(False, True), (True, False)],
                         ids=["serialized-then-pipelined",
                              "pipelined-then-serialized"])
def test_a_finished_checkpoint_replays_as_a_no_op(ds, tmp_path,
                                                  monkeypatch, first, then):
    ck = str(tmp_path / "done.npz")
    want = _run("facade", ds, ckpt=ck, pipeline=first)

    def never(*a, **k):
        raise AssertionError("a finished run dispatched a segment")

    monkeypatch.setattr(engine.SegmentEngine, "dispatch_segment", never)
    got = _run("facade", ds, ckpt=ck, pipeline=then)
    assert_same_run(want, got)


@pytest.mark.parametrize("change", ["seed", "draws", "meta"])
def test_a_mismatched_checkpoint_is_refused(ds, tmp_path, change):
    ck = str(tmp_path / "el.npz")
    _run("el", ds, ckpt=ck)
    kw = {}
    if change == "seed":
        kw = {"seed": 1}
    elif change == "draws":
        kw = {"draws": "jax"}
    else:
        payload, meta = checkpoint.load(ck)
        checkpoint.save(ck, payload, meta={**meta, "fingerprint": "0" * 40})
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _run("el", ds, ckpt=ck, **kw)


def test_ckpt_and_pipeline_need_the_engine_and_ckpt_a_saveable_draws(
        ds, tmp_path):
    ck = str(tmp_path / "x.npz")
    with pytest.raises(ValueError, match="ckpt= needs the segment engine"):
        _run("el", ds, ckpt=ck, engine=False)
    with pytest.raises(ValueError, match="pipeline=True needs the segment"):
        _run("el", ds, pipeline=True, engine=False)

    class Unsaveable:
        def __init__(self, seed):
            self._d = runner.TorchDraws(seed)

        def __getattr__(self, name):
            if name in ("state", "set_state"):
                raise AttributeError(name)
            return getattr(self._d, name)

    with pytest.raises(ValueError, match="state"):
        runner.run_experiment("el", CFG, ds, draws=Unsaveable(0), ckpt=ck,
                              **KW)
    assert not os.path.exists(ck)


@pytest.mark.parametrize("draws", ["torch", "jax"])
def test_a_draws_state_resumes_its_streams(ds, tmp_path, draws):
    """A draws source's state, through a checkpoint file, makes another
    source of the same seed draw what the first draws next."""
    binding = runner.make_binding(CFG)
    src = DRAWS[draws](5)
    src.baseline_init(binding)
    for _ in range(2):
        src.batch_indices(4, 2, 4, 16), src.perms(4, 2), src.gumbel(4)
    checkpoint.save(str(tmp_path / "d.npz"), {"draws": src.state()})
    other = DRAWS[draws](5)
    other.baseline_init(binding)
    other.set_state(checkpoint.load(str(tmp_path / "d.npz"))[0]["draws"])
    for _ in range(2):
        assert torch.equal(src.batch_indices(4, 2, 4, 16),
                           other.batch_indices(4, 2, 4, 16))
        assert torch.equal(src.perms(4, 2), other.perms(4, 2))
        assert torch.equal(src.gumbel(4), other.gumbel(4))


@pytest.mark.parametrize("algo", ["facade", "el"])
def test_the_slice_matches_the_reference(ds, tmp_path, monkeypatch, algo):
    """Pipelined, killed at its third dispatch and resumed, through the
    reference's draws, against the reference's pipelined checkpointed
    run."""
    kw = {**KW, **EXTRA.get(algo, {})}
    kw.pop("device")
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    want = ref_runner.run_experiment(algo, rcfg, ds, pipeline=True,
                                     ckpt=str(tmp_path / "ref.npz"), **kw)
    ck = str(tmp_path / "port.npz")
    _killed_at_third_dispatch(monkeypatch, lambda: _run(
        algo, ds, "jax", ckpt=ck, pipeline=True))
    got = _run(algo, ds, "jax", ckpt=ck, pipeline=True)
    assert got.comm.rounds == want.comm.rounds
    assert got.comm.bytes == want.comm.bytes                 # exact
    assert got.comm.seconds == want.comm.seconds
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
    # both checkpoints say the run finished after the same segment
    metas = [json.loads(json.dumps(checkpoint.load(p)[1]))
             for p in (str(tmp_path / "ref.npz"), ck)]
    assert [(m["next_segment"], m["finished"]) for m in metas] == \
        [(metas[0]["next_segment"], True)] * 2
