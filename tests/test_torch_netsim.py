"""The port's network simulation (``repro_torch.netsim``) against the
reference's ``repro.netsim`` on the CPU, and the statistics of the port's
own netsim stream.

Against the reference the draws are the reference's own uniforms
(``torch_caps.JaxDraws.net_uniform``/``net_randint``, its counter
stream), so masks, channel states, tiers, link matrices, event windows and
the gossip buffers must be equal exactly; simulated seconds within 1e-6
relative (float32 on both sides, other operation orders).

The port's own stream (``CounterDraws``, what ``TorchDraws`` hands out)
cannot match threefry, so it is held to the invariants the reference's
``tests/test_property.py`` pins on its channel, at fixed seeds: the
stationary bad fraction ``p_bad / (p_bad + p_recover)``, the mean burst
length ``1 / p_recover``, symmetric binary masks, and a schedule that
depends on nothing but ``(seed, stream, round)``, so a resumed run draws
what the uninterrupted one drew."""
from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import netsim as ref
from repro_torch import netsim
from repro_torch.core.runner import TorchDraws
from torch_caps import JaxDraws

torch.set_num_threads(1)
N, ROUNDS = 12, 20
EVENTS = (netsim.BurstFailure(start=3, duration=5, fraction=0.4),
          netsim.Partition(start=6, duration=6, groups=3))
CONFIGS = {name: netsim.NetworkConfig.preset(name)
           for name in sorted(netsim.PRESETS)}
CONFIGS["edge-v2+events"] = netsim.NetworkConfig.preset(
    "edge-v2", events=EVENTS, seed=5)
CONFIGS["edge-churn+events"] = netsim.NetworkConfig.preset(
    "edge-churn", events=EVENTS, seed=2)


def ref_net(cfg: netsim.NetworkConfig):
    """The reference's ``NetworkConfig`` with the same fields, its
    ``faults`` a reference ``resil.FaultConfig``."""
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(netsim.NetworkConfig)}
    if cfg.burst is not None:
        kw["burst"] = ref.BurstConfig(**dataclasses.asdict(cfg.burst))
    if cfg.classes is not None:
        kw["classes"] = ref.LinkClasses(**dataclasses.asdict(cfg.classes))
    kw["events"] = tuple(
        getattr(ref, type(ev).__name__)(**dataclasses.asdict(ev))
        for ev in cfg.events)
    if cfg.faults is not None:
        from repro import resil as ref_resil
        kw["faults"] = ref_resil.FaultConfig(
            **dataclasses.asdict(cfg.faults))
    return ref.NetworkConfig(**kw)


def test_the_presets_are_the_references():
    assert set(netsim.PRESETS) == set(ref.PRESETS)
    for name, cfg in CONFIGS.items():
        if "+" not in name:
            assert ref_net(cfg) == ref.NetworkConfig.preset(name)
    hash(CONFIGS["edge-v2+events"])       # frozen: an engine cache key
    with pytest.raises(ValueError, match="unknown netsim preset"):
        netsim.NetworkConfig.preset("nope")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_round_conditions_equal_the_references(name):
    """20 rounds of ``advance_conditions`` from the reference's uniforms:
    every mask and every channel state exact, the preset's and the
    scheduled events' alike."""
    cfg = CONFIGS[name]
    rcfg = ref_net(cfg)
    sched = netsim.NetSchedule(cfg, N, JaxDraws(0))
    chan, want_chan = sched.init_channel("cpu"), ref.init_channel(rcfg, N)
    for rnd in range(ROUNDS):
        conds, chan = netsim.advance_conditions(cfg, sched.round(rnd), chan)
        want, want_chan = ref.advance_conditions(rcfg, N, rnd, want_chan)
        for f in ("edge_mask", "active", "straggler"):
            np.testing.assert_array_equal(getattr(conds, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{f} round {rnd}")
        assert (chan is None) == (want_chan is None)
        if chan is not None:
            np.testing.assert_array_equal(chan.bad.numpy(),
                                          np.asarray(want_chan.bad))
    if cfg.events:              # the windows bit: some round lost nodes
        masks = [netsim.event_masks(cfg.seed, cfg.events, N, r,
                                    JaxDraws(0)) for r in range(ROUNDS)]
        assert min(float(a.min()) for a, _ in masks) == 0.0
        assert min(float(e.min()) for _, e in masks) == 0.0
        for rnd, (a, e) in enumerate(masks):
            wa, we = ref.event_masks(cfg.seed, rcfg.events, N, rnd)
            np.testing.assert_array_equal(a.numpy(), np.asarray(wa))
            np.testing.assert_array_equal(e.numpy(), np.asarray(we))


def _same_stats(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(got[k]), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", ["edge-v2", "bursty-wan", "wan"])
def test_channel_stats_equal_the_references(name):
    cfg = CONFIGS[name]
    got = netsim.channel_stats(cfg, 8, 60, source=JaxDraws(0))
    _same_stats(got, ref.channel_stats(ref_net(cfg), 8, 60))


@pytest.mark.parametrize("name", ["core-edge", "edge-v2"])
def test_tiers_and_link_matrices_equal_the_references(name):
    cfg = CONFIGS[name]
    tiers = netsim.NetSchedule(cfg, N, JaxDraws(0)).tiers
    np.testing.assert_array_equal(
        tiers.numpy(), np.asarray(ref.node_tiers(ref_net(cfg), N)))
    assert 0 < int(tiers.sum()) < N
    lat, bw = netsim.link_matrices(cfg, tiers)
    want_lat, want_bw = ref.link_matrices(ref_net(cfg), N)
    np.testing.assert_array_equal(lat.numpy(), np.asarray(want_lat))
    np.testing.assert_array_equal(bw.numpy(), np.asarray(want_bw))
    assert torch.equal(lat, lat.T) and torch.equal(bw, bw.T)


@pytest.mark.parametrize("name", sorted(netsim.PRESETS))
def test_round_time_equals_the_references(name):
    """Random effective adjacencies, gates and stragglers; the payload a
    float32 tensor as ``netwire.round_seconds`` hands it over; 1e-6
    relative, and an empty round costs 0 on both sides."""
    cfg, rng = CONFIGS[name], np.random.default_rng(4)
    tiers = netsim.NetSchedule(cfg, N, JaxDraws(0)).tiers
    for payload in (49568, 1_234_567):
        upper = np.triu(rng.random((N, N)) < 0.4, 1)
        adj = (upper | upper.T).astype(np.float32)
        active = (rng.random(N) < 0.8).astype(np.float32)
        strag = (rng.random(N) < 0.3).astype(np.float32)
        for act in (active, np.zeros(N, np.float32)):
            got = netsim.round_time(
                cfg, torch.from_numpy(adj),
                torch.full((), float(payload), dtype=torch.float32),
                torch.from_numpy(act), torch.from_numpy(strag), 10,
                tiers=tiers)
            want = ref.round_time(ref_net(cfg), jnp.asarray(adj),
                                  jnp.asarray(payload, jnp.float32),
                                  jnp.asarray(act), jnp.asarray(strag), 10)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
            if not act.any():
                assert float(got) == 0.0


@pytest.mark.parametrize("name", ["async-edge", "edge-v2"])
def test_apply_async_and_fold_gossip_equal_the_references(name):
    """The stale mask from a buffer of mixed ages (some at the cap), the
    buffer handed to the round, and the fold of the round's fresh state:
    the published leaves (float and int) and the ages exact."""
    cfg, rcfg = CONFIGS[name], ref_net(CONFIGS[name])
    rng = np.random.default_rng(1)
    sched = netsim.NetSchedule(cfg, N, JaxDraws(0))
    chan, want_chan = sched.init_channel("cpu"), ref.init_channel(rcfg, N)
    pub = {"w": rng.standard_normal((N, 3, 2)).astype(np.float32),
           "cid": rng.integers(0, 2, N)}
    fresh = {"w": rng.standard_normal((N, 3, 2)).astype(np.float32),
             "cid": rng.integers(0, 2, N)}
    age = rng.integers(0, cfg.max_staleness + 1, N).astype(np.int32)
    gossip = netsim.GossipState(
        {k: torch.from_numpy(v) for k, v in pub.items()},
        torch.from_numpy(age))
    want_gossip = ref.GossipState({k: jnp.asarray(v) for k, v in pub.items()},
                                  jnp.asarray(age))
    stale_seen = 0
    for rnd in range(6):
        conds, chan = netsim.advance_conditions(cfg, sched.round(rnd), chan)
        want, want_chan = ref.advance_conditions(rcfg, N, rnd, want_chan)
        conds, published = netsim.apply_async(cfg, conds, gossip)
        want, want_pub = ref.apply_async(rcfg, want, want_gossip)
        np.testing.assert_array_equal(conds.stale.numpy(),
                                      np.asarray(want.stale))
        stale_seen += int(conds.stale.sum())
        for k in pub:
            np.testing.assert_array_equal(published[k].numpy(),
                                          np.asarray(want_pub[k]))
        gossip = netsim.fold_gossip(
            cfg, gossip, conds, {k: torch.from_numpy(v)
                                 for k, v in fresh.items()})
        want_gossip = ref.fold_gossip(
            rcfg, want_gossip, want, {k: jnp.asarray(v)
                                      for k, v in fresh.items()})
        np.testing.assert_array_equal(gossip.age.numpy(),
                                      np.asarray(want_gossip.age))
        for k in pub:
            np.testing.assert_array_equal(
                gossip.published[k].numpy(),
                np.asarray(want_gossip.published[k]))
    assert stale_seen > 0
    assert netsim.apply_async(cfg.__class__(), conds, None)[1] is None
    assert netsim.init_gossip(CONFIGS["edge-churn"], N, fresh) is None


# ------------------------------------------- the port's own netsim stream --
@pytest.mark.parametrize("p_bad,p_recover,seed", [
    (0.10, 0.40, 0), (0.25, 0.50, 3), (0.05, 0.20, 11)])
def test_torch_draws_hold_the_gilbert_elliott_invariants(p_bad, p_recover,
                                                         seed):
    """``channel_stats`` on ``TorchDraws``' stream, the reference's
    property test's bounds (``tests/test_property.py``): per-link bad and
    loss rates near the stationary ones, the mean burst length near
    ``1 / p_recover``, symmetric {0, 1} masks and states."""
    burst = netsim.BurstConfig(p_bad=p_bad, p_recover=p_recover,
                               drop_good=0.0, drop_bad=1.0)
    cfg = netsim.NetworkConfig(burst=burst, seed=seed)
    stats = netsim.channel_stats(cfg, 6, 600, source=TorchDraws(0))
    assert abs(stats["bad_rate"] - burst.stationary_bad()) < 0.10
    assert abs(stats["loss_rate"] - burst.stationary_drop()) < 0.10
    want = 1.0 / p_recover
    assert stats["n_bursts"] > 20
    assert abs(stats["mean_burst_len"] - want) < max(0.4, 0.35 * want)
    assert stats["symmetric"] and stats["binary"]


def test_torch_draws_give_a_stable_resumable_schedule():
    """A round's draws depend on ``(net seed, stream, round)`` only: two
    draws sources of different experiment seeds, rounds drawn in another
    order, and a source whose generators advanced give the same
    ``NetDraws``; drawing them moves none of the source's generators (a
    checkpoint needs no netsim state). Another net seed gives other
    draws."""
    cfg = netsim.NetworkConfig.preset("edge-v2", events=EVENTS)
    a, b = TorchDraws(0), TorchDraws(9)
    before = a.state()
    first = [netsim.NetSchedule(cfg, N, a).round(r) for r in range(8)]
    b.batch_indices(N, 2, 4, 16)
    later = netsim.NetSchedule(cfg, N, b)
    again = {r: later.round(r) for r in reversed(range(8))}
    for r, nd in enumerate(first):
        for x, y in zip(nd, again[r]):
            assert (x is None and y is None) or torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(
        (before[k] for k in sorted(before)),
        (a.state()[k] for k in sorted(before))))
    other = netsim.NetSchedule(dataclasses.replace(cfg, seed=1), N, a)
    assert not torch.equal(other.round(0).drop, first[0].drop)
    u = first[0].drop
    assert u.dtype == torch.float32 and u.shape == (N, N)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    camps = netsim.CounterDraws().net_randint(0, 1000, 1, (64,), 3)
    assert set(camps.tolist()) == {0, 1, 2}
