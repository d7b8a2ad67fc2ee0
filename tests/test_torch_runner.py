"""``run_experiment`` of the port against the reference's per-round
loop (``engine=False``) at a quickstart-like size, with the reference's
draws replayed (``torch_caps.JaxDraws``): the same initial parameters,
batches and topologies go through both.

All five algorithms are held to the same checks. Tolerances: accuracies,
fair accuracy, DP and EO within 0.1, the reference's own precedent
across layouts (``tests/test_mesh.py``); the per-round bytes and the
FACADE cluster history are exact; DAC's Gumbel draws and sampled
neighbours exact, its similarities 1e-5 relative.

The FACADE runs decorrelate the initial heads (``head_jitter``): with
identical heads every round-1 selection is a loss tie at the last ulp,
which the two frameworks may break differently
(``test_torch_round.py::test_identical_heads_make_round_one_a_near_tie``),
and cluster ids are exact only away from near-ties."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.core import runner as ref_runner
from repro.core.baselines import dac as ref_dac
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_baseline_state as ref_init_baseline
from repro.data import pipeline as ref_pipeline
from repro_torch.configs import facade_paper
from repro_torch.core import runner
from repro_torch.core.baselines import dac
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import init_baseline_state
from repro_torch.data import pipeline, synthetic
from torch_caps import JaxDraws

torch.set_num_threads(1)
TOL = 0.1
KW = dict(rounds=6, k=2, degree=2, local_steps=3, batch_size=8, lr=0.05,
          eval_every=2, seed=0)


@pytest.fixture(scope="module")
def ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=16,
                               seed=3)
    return synthetic.make_clustered_data(spec, (6, 2), ("rot0", "rot180"))


def _cfgs():
    return (ref_configs.lenet(smoke=True).replace(n_classes=4),
            facade_paper.lenet(smoke=True).replace(n_classes=4))


@pytest.mark.parametrize("algo,extra", [
    ("facade", {"head_jitter": 0.05}),
    ("facade", {"head_jitter": 0.2, "degree": 3}),
    ("el", {}),
    ("dpsgd", {}),
    ("deprl", {}),
    ("dac", {}),
], ids=["facade", "facade-degree3", "el", "dpsgd", "deprl", "dac"])
def test_run_experiment_matches_the_reference(ds, algo, extra):
    rcfg, cfg = _cfgs()
    kw = {**KW, **extra}
    want = ref_runner.run_experiment(algo, rcfg, ds, engine=False, **kw)
    got = runner.run_experiment(algo, cfg, ds, device="cpu",
                                draws=JaxDraws(kw["seed"]), **kw)
    assert got.comm.rounds == want.comm.rounds
    assert got.comm.bytes == want.comm.bytes                 # exact
    assert [r for r, _ in got.acc_per_cluster] == \
        [r for r, _ in want.acc_per_cluster]
    for (_, a), (_, b) in zip(got.acc_per_cluster, want.acc_per_cluster):
        np.testing.assert_allclose(a, b, atol=TOL)
    np.testing.assert_allclose(got.final_acc, want.final_acc, atol=TOL)
    np.testing.assert_allclose([v for _, v in got.fair_acc],
                               [v for _, v in want.fair_acc], atol=TOL)
    assert abs(got.dp - want.dp) <= TOL and abs(got.eo - want.eo) <= TOL
    assert len(got.cluster_history) == len(want.cluster_history)
    for (r1, c1), (r2, c2) in zip(got.cluster_history,
                                  want.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, np.asarray(c2))
    assert len(got.eval_frames) == len(want.eval_frames)
    for f1, f2 in zip(got.eval_frames, want.eval_frames):
        assert f1.round == f2.round and f1.cluster_ids == f2.cluster_ids
        assert f1.cluster_churn == f2.cluster_churn
        assert abs(f1.mean_acc - f2.mean_acc) <= TOL
    assert np.isfinite(np.concatenate(
        [l.numpy().ravel() for l in _leaves(got.models)])).all()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_dac_rounds_sample_the_reference_neighbours(ds):
    """Two DAC rounds from the reference's draws (``JaxDraws``): each
    round's Gumbel matrix equals the reference's, and so do the neighbours
    it samples (the similarity entries a round writes; round 2 ranks
    ``tau * sim`` of round 1 plus its noise). Similarities within 1e-5
    relative: inverse losses of the same models on the same batches."""
    rcfg, cfg = _cfgs()
    rb, pb = ref_make_binding(rcfg), make_binding(cfg)
    n, h, b, deg = ds.n_nodes, KW["local_steps"], KW["batch_size"], 2
    k_init, k_data = jax.random.split(jax.random.PRNGKey(0))
    want = ref_init_baseline(rb, k_init, n,
                             extra=ref_dac.init_dac_extra(n))
    step = jax.jit(functools.partial(
        ref_dac.dac_round, ref_dac.DACConfig(n_nodes=n, degree=deg,
                                             local_steps=h, lr=0.05), rb))
    draws = JaxDraws(0)
    got = init_baseline_state(pb, n, params=draws.baseline_init(pb),
                              extra=dac.init_dac_extra(n), device="cpu")
    train_x, train_y = pipeline.place(ds, "cpu")
    pcfg = dac.DACConfig(n_nodes=n, degree=deg, lr=0.05)
    for _ in range(2):
        k_data, k_b = jax.random.split(k_data)
        g_want = jax.random.gumbel(jax.random.split(want.rng)[1], (n, n))
        want, want_info = step(want, ref_pipeline.sample_round_batches(
            k_b, jnp.asarray(ds.train_x), jnp.asarray(ds.train_y), h, b))
        batches = pipeline.sample_round_batches(
            draws.batch_indices(n, h, b, train_x.shape[1]), train_x,
            train_y)
        gumbel = draws.gumbel(n)
        np.testing.assert_array_equal(gumbel.numpy(), np.asarray(g_want))
        before = got.extra["sim"]
        got, info = dac.dac_round(pcfg, pb, got, batches, gumbel)
        written = (got.extra["sim"] != before).numpy()
        np.testing.assert_array_equal(
            written, np.asarray(want.extra["sim"]) != before.numpy())
        assert (written.sum(1) == deg).all() and not written.diagonal().any()
        np.testing.assert_allclose(got.extra["sim"].numpy(),
                                   np.asarray(want.extra["sim"]),
                                   rtol=1e-5, atol=0)
        assert info["round_bytes"] == float(want_info["round_bytes"])


def test_port_draws_are_seeded_and_device_independent(ds):
    _, cfg = _cfgs()
    kw = dict(KW, rounds=2, eval_every=2)
    a = runner.run_experiment("facade", cfg, ds, device="cpu", **kw)
    b = runner.run_experiment("facade", cfg, ds, device="cpu", **kw)
    assert a.final_acc == b.final_acc and a.comm.bytes == b.comm.bytes
    for (_, c1), (_, c2) in zip(a.cluster_history, b.cluster_history):
        np.testing.assert_array_equal(c1, c2)


@pytest.mark.parametrize("bad,match", [
    ({"eval_every": 0}, "eval_every"),
    ({"degree": 8}, "degree"),
    ({"target_acc": 0.5, "eval_every": 7}, "target_acc"),
])
def test_invalid_settings_raise(ds, bad, match):
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match=match):
        runner.run_experiment("el", cfg, ds, device="cpu", **{**KW, **bad})


def test_unported_algorithms_and_options_are_refused(ds):
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="not ported"):
        runner.run_experiment("sgp", cfg, ds, device="cpu", **KW)
    with pytest.raises(TypeError):
        runner.run_experiment("el", cfg, ds, device="cpu", net="edge-churn",
                              **KW)


def test_target_acc_stops_at_the_first_eval_that_reaches_it(ds):
    _, cfg = _cfgs()
    res = runner.run_experiment("facade", cfg, ds, device="cpu",
                                **{**KW, "target_acc": 0.0})
    assert [r for r, _ in res.acc_per_cluster] == [2]
    assert res.comm.rounds == [1, 2]


@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False)], ids=str)
def test_run_experiment_runs_without_tf32_and_restores_the_flags(ds, flags):
    """TF32 is off for cuBLAS and cuDNN during the run (seen from the
    draws source, which the run calls each round), and the caller's flags
    come back after it, also when the run raises."""
    seen = []

    class Draws(runner.TorchDraws):
        def batch_indices(self, *args):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            if len(seen) > 2:
                raise RuntimeError("stop")
            return super().batch_indices(*args)

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        cfg = _cfgs()[1]
        runner.run_experiment("el", cfg, ds, device="cpu", draws=Draws(0),
                              **{**KW, "rounds": 2})
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
        with pytest.raises(RuntimeError, match="stop"):
            runner.run_experiment("el", cfg, ds, device="cpu",
                                  draws=Draws(0), **{**KW, "rounds": 2})
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
        assert seen == [(False, False)] * 3
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
