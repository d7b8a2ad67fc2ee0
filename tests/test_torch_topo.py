"""The port's adaptive topology (``repro_torch.topo``) on the CPU, against
the reference's ``repro.topo`` on the same numpy inputs and draws, and
against itself.

* Module parity: ``advance`` rolled under ``core-edge`` and
  ``bursty-wan`` from the reference's netsim uniforms (EWMAs within 1e-6
  relative), ``link_scores``, ``link_logits`` and
  ``participation_probs`` on random and hostile states (the floor exact),
  ``sample`` and ``gumbel_graph`` from the reference's keys
  (``JaxDraws``), with DAC's ``extra_logits`` and in the masked-tie case,
  a DAC round in that case, and ``inclusion_stats`` on ``core-edge``:
  adjacency, participation and the structural flags exact.
* Run parity: the five algorithms under ``reliability`` and
  ``core-edge`` (DAC's round above runs without ``net``), against the
  reference's ``engine=False`` loop (bytes exact, seconds 1e-6 relative,
  cluster ids exact with ``head_jitter > 0``, accuracy, DP and EO 0.1).
* The port against itself, bit for bit: the engine (serialized and
  pipelined) against the loop for the five, with and without ``net``;
  ``TopoConfig()`` against ``topo=None`` on both drivers; a run killed at
  its third segment dispatch and resumed.
* Accounting and validation: adaptive bytes without ``net`` count the
  drawn graph (at most nominal, more than 0); every ``TopoConfig`` field
  forks the cache key; the config's checks and the out-of-range budget
  raise.

The reference's tiny set-up (``tests/test_topo.py``): smoke GN-LeNet, 4
classes, 4 nodes in clusters 3:1, 3 rounds, degree 2."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import netsim as ref_netsim
from repro import topo as ref_topo
from repro.configs import facade_paper as ref_configs
from repro.core import runner as ref_runner
from repro.core.baselines import dac as ref_dac
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.netwire import comm_info as ref_comm_info
from repro.core.state import init_baseline_state as ref_init_baseline
from repro.data import pipeline as ref_pipeline
from repro_torch import checkpoint, topo
from repro_torch.configs import facade_paper
from repro_torch.core import runner, topology
from repro_torch.core.baselines import dac
from repro_torch.core.bindings import make_binding
from repro_torch.core.cache import EngineCache, EngineSpec
from repro_torch.core.netwire import comm_info
from repro_torch.core.state import init_baseline_state
from repro_torch.data import pipeline, synthetic
from repro_torch.netsim import NetSchedule, NetworkConfig, advance_conditions
from repro_torch.topo import TopoConfig, TopoState
from test_torch_netsim import ref_net
from test_torch_resume import (_killed_at_third_dispatch, assert_same_run,
                               assert_same_checkpoint)
from torch_caps import JaxDraws

torch.set_num_threads(1)
TOL = 0.1
CFG = facade_paper.lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=3, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=1, seed=0, device="cpu")
EXTRA = {"facade": {"head_jitter": 0.05}}
ADAPTIVE = TopoConfig(policy="reliability", min_inclusion=0.2, decay=0.7)


def ref_topo_cfg(cfg: TopoConfig):
    return ref_topo.TopoConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8, seed=3)
    return synthetic.make_clustered_data(spec, (3, 1), ("rot0", "rot180"))


def _kw(algo, **more):
    return {**KW, **EXTRA.get(algo, {}), **more}


def _states(n: int, weak=(0,), lo=1e-8, hi=5.0, seed=0):
    """(a random state, a hostile one) as numpy pairs: the random one's
    delivery in [0, 1) and link seconds in [0.01, 2), symmetric with a
    zero diagonal; the hostile one's links touching a ``weak`` node near
    worthless and the others great (the reference tests' hostile
    state)."""
    rng = np.random.default_rng(seed)

    def sym(a):
        a = np.triu(a, 1)
        return (a + a.T).astype(np.float32)

    rand = (sym(rng.random((n, n))), sym(0.01 + 1.99 * rng.random((n, n))))
    d = np.full((n, n), hi, np.float32)
    for w in weak:
        d[w, :] = d[:, w] = lo
    np.fill_diagonal(d, 0.0)
    return rand, (d, np.ones((n, n), np.float32))


def _pair(arrays):
    """The same state as the port's and the reference's ``TopoState``."""
    d, s = arrays
    return (TopoState(torch.from_numpy(d.copy()), torch.from_numpy(s.copy())),
            ref_topo.TopoState(jnp.asarray(d), jnp.asarray(s)))


# ---------------------------------------------------------- module parity --
@pytest.mark.parametrize("preset", ["core-edge", "bursty-wan"])
def test_advance_matches_the_reference(preset):
    """40 rounds of conditions from the reference's netsim uniforms
    folded into the EWMAs: within 1e-6 relative of the reference's after
    every round; under ``core-edge`` the tiers separate (links touching an
    edge node learn a larger link time than core links)."""
    net = NetworkConfig.preset(preset, seed=5)
    rnet, cfg = ref_net(net), TopoConfig(policy="reliability", decay=0.7)
    n = 12
    got = topo.init_state(cfg, net, n, "cpu")
    want = ref_topo.init_state(ref_topo_cfg(cfg), rnet, n)
    sched = NetSchedule(net, n, JaxDraws(0))
    chan, rchan = sched.init_channel("cpu"), ref_netsim.init_channel(rnet, n)
    for rnd in range(40):
        drawn = sched.round(rnd)
        conds, chan = advance_conditions(net, drawn, chan)
        rconds, rchan = ref_netsim.advance_conditions(rnet, n, rnd, rchan)
        got = topo.advance(cfg, net, got, conds, tiers=drawn.tiers)
        want = ref_topo.advance(ref_topo_cfg(cfg), rnet, want, rconds)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)
    link_s = got.link_s.numpy()
    assert np.array_equal(link_s, link_s.T)
    assert not link_s.diagonal().any() and not got.delivery.diagonal().any()
    if net.classes is not None:
        tiers = sched.tiers.numpy()
        assert 0 < tiers.sum() < n
        edge = np.maximum(tiers[:, None], tiers[None, :]) > 0
        off = ~np.eye(n, dtype=bool)
        assert link_s[edge & off].min() > link_s[~edge & off].max()


@pytest.mark.parametrize("policy", ["reliability", "bandwidth"])
def test_scores_logits_and_probs_match_the_reference(policy):
    n = 12
    for floor in (0.0, 0.2, 1.0):
        cfg = TopoConfig(policy=policy, min_inclusion=floor)
        rcfg = ref_topo_cfg(cfg)
        for arrays in _states(n, weak=(2, 5)):
            got, want = _pair(arrays)
            for name in ("link_scores", "participation_probs"):
                np.testing.assert_allclose(
                    getattr(topo, name)(cfg, got).numpy(),
                    np.asarray(getattr(ref_topo, name)(rcfg, want)),
                    rtol=1e-6, atol=0)
            np.testing.assert_allclose(
                topo.link_logits(cfg, got, n).numpy(),
                np.asarray(ref_topo.link_logits(rcfg, want, n)),
                rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="no link scores"):
        topo.link_scores(TopoConfig(), got)


def test_the_floor_is_exact_under_hostile_scores():
    """``p >= min_inclusion`` for every node whatever the scores, the
    all-zero matrix included; the best-connected node always takes
    part."""
    n = 10
    for floor in (0.0, 0.1, 0.25, 0.9, 1.0):
        cfg = TopoConfig(policy="reliability", min_inclusion=floor)
        hostile = _pair(_states(n, weak=(2,))[1])[0]
        zero = TopoState(torch.zeros((n, n)), torch.ones((n, n)))
        for state in (hostile, zero):
            p = topo.participation_probs(cfg, state)
            assert bool((p >= floor).all()) and bool((p <= 1.0).all())
        assert float(topo.participation_probs(cfg, hostile).max()) == 1.0


def _untied_rows(part: np.ndarray, kpick: int) -> np.ndarray:
    """Rows whose ``kpick`` picks are all participants (so no pick is
    among the -1e9 ties of the non-participants' columns)."""
    n = part.shape[0]
    peers = part[None, :] * (1 - np.eye(n))
    return peers.sum(1) >= kpick


def test_sample_matches_the_reference():
    """The reference's ``sample`` from ``PRNGKey(seed)`` and the port's
    from the same key's draws (``JaxDraws``): equal adjacency and
    participation, symmetric, zero diagonal, within the edge budget."""
    n, draws = 12, JaxDraws(0)
    cfg = TopoConfig(policy="reliability", min_inclusion=0.2)
    rcfg = ref_topo_cfg(cfg)
    for r in (1, 2, 4, 5):
        for seed in range(4):
            for arrays in _states(n, weak=(seed % n,), seed=seed):
                got, want = _pair(arrays)
                key = jax.random.PRNGKey(seed)
                d = draws._policy_draw(key, n)
                adj = topo.sample(cfg, got, d.u, d.gumbel, n, r).numpy()
                np.testing.assert_array_equal(
                    adj, np.asarray(ref_topo.sample(rcfg, want, key, n, r)))
                np.testing.assert_array_equal(
                    topo.participants(cfg, got, d.u).numpy(),
                    np.asarray(ref_topo.participants(
                        rcfg, want, jax.random.split(key)[0], n)))
                assert np.array_equal(adj, adj.T)
                assert not adj.diagonal().any()
                assert adj.sum() <= 2 * n * max(1, r // 2)


@pytest.mark.parametrize("case", ["dac_logits", "masked_ties"])
def test_gumbel_graph_matches_the_reference(case):
    """``gumbel_graph`` with DAC's similarity logits (``tau * sim - 1e9 *
    eye``) added in the reference's order: equal adjacency and
    participation, equal picks on every row whose picks are all
    participants. ``masked_ties``: a floor of 0 and six starved nodes of
    eight,
    so participants with fewer participating peers than ``kpick`` pick
    among the exactly tied non-participants; the adjacency is still
    equal."""
    n, kpick, draws = 8, 3, JaxDraws(0)
    cfg = TopoConfig(policy="bandwidth" if case == "dac_logits"
                     else "reliability",
                     min_inclusion=0.0 if case == "masked_ties" else 0.2)
    rcfg = ref_topo_cfg(cfg)
    rng = np.random.default_rng(1)
    tied = 0
    for seed in range(3):
        arrays = _states(n, weak=tuple(range(6)), seed=seed)
        got, want = _pair(arrays[1] if case == "masked_ties"
                          else arrays[0])
        sim = (rng.random((n, n)).astype(np.float32)
               if case == "dac_logits" else np.zeros((n, n), np.float32))
        key = jax.random.PRNGKey(seed)
        d = draws._policy_draw(key, n)
        adj, nbr, part = topo.gumbel_graph(
            cfg, got, d.u, d.gumbel, n, kpick,
            extra_logits=30.0 * torch.from_numpy(sim)
            - 1e9 * torch.eye(n))
        radj, rnbr, rpart = ref_topo.gumbel_graph(
            rcfg, want, key, n, kpick,
            extra_logits=30.0 * jnp.asarray(sim) - 1e9 * jnp.eye(n))
        np.testing.assert_array_equal(adj.numpy(), np.asarray(radj))
        np.testing.assert_array_equal(part.numpy(), np.asarray(rpart))
        rows = _untied_rows(part.numpy(), kpick)
        np.testing.assert_array_equal(nbr.numpy()[rows],
                                      np.asarray(rnbr)[rows])
        tied += int((part.numpy() > 0)[~rows].sum())
    if case == "masked_ties":
        assert tied > 0        # the case is pinned: some participant ties


def test_dac_round_with_masked_ties_matches_the_reference(ds):
    """One DAC round under an adaptive policy whose two starved nodes sit
    out (floor 0), from the reference's draws: each participant has one
    participating peer, fewer than DAC's ``kpick`` (the degree), so its
    second pick is among tied non-participants. The round's adjacency
    and bytes are the reference's exactly, the similarity is written at
    the same entries (the participants' exchange; a pick of a
    non-participant writes the old value back) within 1e-5 relative."""
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    rb, pb = ref_make_binding(rcfg), make_binding(CFG)
    n, h, b, deg = ds.n_nodes, KW["local_steps"], KW["batch_size"], 2
    cfg = TopoConfig(policy="reliability", min_inclusion=0.0)
    got_t, want_t = _pair(_states(n, weak=(0, 1))[1])
    k_init, k_data = jax.random.split(jax.random.PRNGKey(0))
    want = ref_init_baseline(rb, k_init, n,
                             extra=ref_dac.init_dac_extra(n))
    draws = JaxDraws(0)
    got = init_baseline_state(pb, n, params=draws.baseline_init(pb),
                              extra=dac.init_dac_extra(n), device="cpu")
    k_data, k_b = jax.random.split(k_data)
    want, want_info = jax.jit(functools.partial(
        ref_dac.dac_round, ref_dac.DACConfig(n_nodes=n, degree=deg,
                                             local_steps=h, lr=0.05), rb,
        topo_cfg=ref_topo_cfg(cfg)))(
        want, ref_pipeline.sample_round_batches(
            k_b, jnp.asarray(ds.train_x), jnp.asarray(ds.train_y), h, b),
        topo=want_t)
    train_x, train_y = pipeline.place(ds, "cpu")
    batches = pipeline.sample_round_batches(
        draws.batch_indices(n, h, b, train_x.shape[1]), train_x, train_y)
    drawn = draws.policy_draw(n)
    part = topo.participants(cfg, got_t, drawn.u).numpy()
    assert part.tolist() == [0.0, 0.0, 1.0, 1.0]      # the pinned case
    got, info = dac.dac_round(dac.DACConfig(n_nodes=n, degree=deg, lr=0.05),
                              pb, got, batches, drawn, topo=got_t,
                              topo_cfg=cfg)
    np.testing.assert_array_equal(info["adj_eff"].numpy(),
                                  np.asarray(want_info["adj_eff"]))
    assert float(info["round_bytes"]) == float(want_info["round_bytes"])
    sim, want_sim = got.extra["sim"].numpy(), np.asarray(want.extra["sim"])
    np.testing.assert_array_equal(sim != 0, want_sim != 0)
    assert (sim != 0).sum() == 2 and sim[2, 3] > 0 and sim[3, 2] > 0
    np.testing.assert_allclose(sim, want_sim, rtol=1e-5, atol=0)


def test_inclusion_stats_match_the_reference_on_core_edge():
    """From the reference's draws the port's statistics are the
    reference's (inclusion, participation, degrees, edges and flags
    exact); from its own counter draws the floor holds over 300 rounds
    within 3 sigma, inside the edge budget."""
    net = NetworkConfig.preset("core-edge")
    cfg = TopoConfig(policy="reliability", min_inclusion=0.3)
    got = topo.inclusion_stats(cfg, net, n=10, rounds=60, degree=4, seed=2,
                               draws=JaxDraws(0), device="cpu")
    want = ref_topo.inclusion_stats(ref_topo_cfg(cfg), ref_net(net), n=10,
                                    rounds=60, degree=4, seed=2)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    own = topo.inclusion_stats(cfg, net, n=10, rounds=300, degree=4,
                               device="cpu")
    assert own["symmetric"] and own["binary"]
    assert own["mean_edges"] <= own["edge_budget"]
    sigma = np.sqrt(0.3 * 0.7 / 300)
    assert own["inclusion"].min() >= 0.3 - 3 * sigma
    assert own["participation"].min() >= 0.3 - 3 * sigma
    with pytest.raises(ValueError, match="adaptive"):
        topo.inclusion_stats(TopoConfig(), net, n=10, rounds=10, degree=4,
                             device="cpu")


def test_comm_info_counts_the_drawn_edges():
    n = 4
    adj = topology.ring(n, 2)
    nominal = comm_info(None, adj, 100, n * 2)
    actual = comm_info(None, adj, 100, n * 2, actual=True)
    assert nominal["round_bytes"] == float(ref_comm_info(
        None, jnp.asarray(adj.numpy()), 100, n * 2)["round_bytes"])
    assert float(actual["round_bytes"]) == float(ref_comm_info(
        None, jnp.asarray(adj.numpy()), 100, n * 2,
        actual=True)["round_bytes"]) == float(adj.sum()) * 100


def test_counter_draws_replay_and_tag_streams():
    a = topo.counter_draw(0, topo.TOPO_STREAM, 3, 6)
    b = runner.TorchDraws(9).policy_draw_at(0, topo.TOPO_STREAM, 3, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = topo.counter_draw(0, None, 3, 6)
    assert not torch.equal(a.u, c.u)
    assert a.u.shape == (6,) and a.gumbel.shape == (6, 6)
    assert bool(torch.isfinite(a.gumbel).all())


# ------------------------------------------------------------ run parity --
@pytest.mark.parametrize("algo", runner.ALGOS)
def test_run_matches_the_reference_loop(ds, algo):
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    kw, net = _kw(algo), NetworkConfig.preset("core-edge")
    want = ref_runner.run_experiment(
        algo, rcfg, ds, engine=False, net=ref_net(net),
        topo=ref_topo_cfg(ADAPTIVE),
        **{k: v for k, v in kw.items() if k != "device"})
    got = runner.run_experiment(algo, CFG, ds, draws=JaxDraws(kw["seed"]),
                                net=net, topo=ADAPTIVE, **kw)
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


# ------------------------------------------------------- port vs itself --
@pytest.mark.parametrize("algo", runner.ALGOS)
def test_engine_equals_the_loop(ds, algo):
    """With and without ``net``, the engine (serialized and pipelined) is
    the loop's run bit for bit, and the policy changed the run."""
    for net in (NetworkConfig.preset("core-edge"), None):
        kw = _kw(algo, rounds=4, eval_every=2, net=net)
        loop = runner.run_experiment(algo, CFG, ds, engine=False,
                                     topo=ADAPTIVE, **kw)
        assert_same_run(runner.run_experiment(algo, CFG, ds, topo=ADAPTIVE,
                                              **kw), loop)
        assert_same_run(runner.run_experiment(algo, CFG, ds, topo=ADAPTIVE,
                                              pipeline=True, **kw), loop)
        base = runner.run_experiment(algo, CFG, ds, **kw)
        assert (base.comm.bytes != loop.comm.bytes
                or base.acc_per_cluster != loop.acc_per_cluster)


@pytest.mark.parametrize("algo", runner.ALGOS)
def test_uniform_policy_is_the_run_without_a_policy(ds, algo):
    """``TopoConfig()`` is ``topo=None`` bit for bit, on both drivers,
    under ``core-edge`` and (engine) on the ideal medium."""
    net = NetworkConfig.preset("core-edge")
    for engine, n_ in ((True, net), (False, net), (True, None)):
        kw = _kw(algo, engine=engine, net=n_)
        assert_same_run(runner.run_experiment(algo, CFG, ds,
                                              topo=TopoConfig(), **kw),
                        runner.run_experiment(algo, CFG, ds, **kw))


@pytest.mark.parametrize("algo", ["facade", "el"])
def test_adaptive_bytes_without_net_count_the_drawn_graph(ds, algo):
    """Without ``net`` the nominal count becomes the drawn graph's
    directed edges times the payload: a whole number of payloads each
    round, at most the nominal ``n * degree`` of them (the edge budget),
    more than 0; the engine drains the same per-round values."""
    kw = _kw(algo)
    nominal = runner.run_experiment(algo, CFG, ds, **kw)
    ada = runner.run_experiment(algo, CFG, ds, topo=ADAPTIVE, **kw)
    per = np.diff([0.0] + ada.comm.bytes)
    payload = np.diff([0.0] + nominal.comm.bytes)[0] / (
        ds.n_nodes * KW["degree"])
    edges = per / payload
    assert np.array_equal(edges, np.rint(edges))
    assert (edges > 0).all() and (edges <= ds.n_nodes * KW["degree"]).all()
    assert ada.comm.bytes[-1] <= nominal.comm.bytes[-1]
    assert ada.comm.seconds == [0.0] * KW["rounds"]


@pytest.mark.parametrize("algo,preset", [("facade", "core-edge"),
                                         ("dpsgd", "core-edge"),
                                         ("el", None)])
def test_kill_and_resume(ds, tmp_path, monkeypatch, algo, preset):
    """A pipelined, checkpointed adaptive run killed at its third segment
    dispatch and resumed by the same call ends as the uninterrupted run,
    final checkpoints equal; the checkpoint holds the EWMAs."""
    kw = _kw(algo, rounds=5, eval_every=1, topo=ADAPTIVE,
             net=None if preset is None else NetworkConfig.preset(preset))
    whole, ck = str(tmp_path / "whole.npz"), str(tmp_path / "killed.npz")
    want = runner.run_experiment(algo, CFG, ds, ckpt=whole, **kw)
    _killed_at_third_dispatch(monkeypatch, lambda: runner.run_experiment(
        algo, CFG, ds, ckpt=ck, pipeline=True, **kw))
    assert checkpoint.load(ck)[1]["next_segment"] in (1, 2)
    got = runner.run_experiment(algo, CFG, ds, ckpt=ck, pipeline=True,
                                cache=EngineCache(), **kw)
    assert_same_run(got, want)
    assert_same_checkpoint(whole, ck)
    saved = checkpoint.load(ck)[0]["topo"]
    assert sorted(saved) == ["delivery", "link_s"]
    if preset is None:       # nothing observed: the EWMAs stay neutral
        assert torch.equal(saved["link_s"], 1.0 - torch.eye(ds.n_nodes))


# ------------------------------------------------------------ validation --
@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(TopoConfig)])
def test_every_topo_field_forks_the_cache_key(field):
    base = TopoConfig(policy="reliability", degree=2)
    other = {"policy": "bandwidth", "decay": 0.5, "degree": 3,
             "min_inclusion": 0.3, "ref_payload_bytes": 5e4, "seed": 1}
    spec = EngineSpec(algo="facade", cfg=CFG, n=4, k=2, degree=2,
                      local_steps=2, batch_size=4, lr=0.05,
                      device=torch.device("cpu"), topo=base)
    forked = dataclasses.replace(
        spec, topo=dataclasses.replace(base, **{field: other[field]}))
    assert forked != spec and hash(forked) != hash(spec)
    cache = EngineCache()
    cache._entries[spec] = object()
    assert spec in cache and forked not in cache


def test_topo_config_validation(ds):
    assert dataclasses.asdict(TopoConfig()) == dataclasses.asdict(
        ref_topo.TopoConfig())                    # the same defaults
    assert hash(ADAPTIVE) == hash(dataclasses.replace(ADAPTIVE))
    assert topo.POLICIES == ref_topo.POLICIES
    for bad, match in (({"policy": "random"}, "unknown topology policy"),
                       ({"min_inclusion": 1.5}, "min_inclusion"),
                       ({"decay": 1.0}, "decay")):
        with pytest.raises(ValueError, match=match):
            TopoConfig(**bad)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ADAPTIVE.decay = 0.1
    assert topo.budget(None, 2) == topo.budget(TopoConfig(), 2) == 2
    assert topo.budget(TopoConfig(degree=3), 2) == 3
    # the budget's degree is checked like the run's: n = 4 nodes
    with pytest.raises(ValueError, match="degree=4 out of range"):
        runner.run_experiment("el", CFG, ds, topo=TopoConfig(
            policy="reliability", degree=4), **KW)
    with pytest.raises(TypeError, match="topo must be"):
        runner.run_experiment("el", CFG, ds, topo="reliability", **KW)
    assert topo.init_state(TopoConfig(), None, 4, "cpu") is None
    st = topo.init_state(ADAPTIVE, None, 4, "cpu")
    assert st.delivery.data_ptr() != st.link_s.data_ptr()
    assert torch.equal(st.delivery, 1.0 - torch.eye(4))
