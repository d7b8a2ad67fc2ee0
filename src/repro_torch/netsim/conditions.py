"""Network-condition models (churn, message loss, stragglers, bursty
links, heterogeneous link tiers), the port of ``repro.netsim.conditions``.

A :class:`NetworkConfig` is static (frozen and hashable: it is part of the
engine's cache key). Each round's conditions are dense masks, a
:class:`RoundConditions` that the round functions in ``core/`` consume:

* ``edge_mask [n, n]``  — 1 where the link delivered this round's message
  (symmetric: gossip is push-pull, a lost exchange is lost both ways);
* ``active [n]``        — 1 where the node is online this round (churn);
* ``straggler [n]``     — 1 where the node is slow this round. Stragglers
  still train and gossip; in a synchronous round they only stretch the
  simulated wall-clock time (:mod:`.timing`); under asynchronous gossip
  (``async_gossip=True``) they serve stale snapshots instead
  (:mod:`.gossip`);
* ``stale [n]``         — 1 where the node's neighbours observe its stale
  published snapshot this round (async gossip only; ``None`` otherwise).

Churn is drawn per *outage block* (``round // outage_rounds``), so an
offline node stays offline for ``outage_rounds`` consecutive rounds.

**Draws are inputs.** The reference draws every mask from the counter
stream ``fold_in(fold_in(PRNGKey(cfg.seed), tag), index)``. Here the raw
uniforms come from the run's draws source, ``source.net_uniform(seed,
tag, index, shape)`` (and ``net_randint`` for a partition's camps), on the
host, and everything after the uniform (the mirrored upper triangle, the
thresholds, the Gilbert–Elliott step, the event windows and the products)
runs here on the tensors, on the run's device. :class:`CounterDraws` is
the port's own stream: a CPU ``torch.Generator`` seeded per call from
``SeedSequence([seed, tag, index])``, so a schedule depends on ``(seed,
tag, index)`` alone and replays forever, in the loop, in the engine and
after a resume, with no state to checkpoint. Fed the reference's uniforms,
the functions here give the reference's masks bit for bit.

One round's uniforms travel as a :class:`NetDraws`, made on the host by
:class:`NetSchedule` (which draws a run's static ones, the node tiers and
the channel's initial state, once).

Bursty loss (``burst=BurstConfig(...)``) replaces the i.i.d. ``drop_rate``
coin with a per-link two-state Gilbert–Elliott chain: each undirected link
is *good* (loss probability ``drop_good``) or *bad* (``drop_bad``); per
round a good link turns bad with ``p_bad`` and a bad one recovers with
``p_recover``. The chain's state, :class:`ChannelState`, lives on the
device in the engine's carry (or the loop's variables) and is advanced by
:func:`advance_conditions`.

Node faults (``NetworkConfig.faults``, a
:class:`repro_torch.resil.FaultConfig`) ride the same draws: under a crash
chain the round's ``crash`` and ``restart`` uniforms, under corruption
its ``corrupt`` uniforms and, in noise mode, one normal tensor per float
leaf of the sent tree (``net_normal``); :func:`repro_torch.resil.advance`
folds them into the round's ``crashed``, ``corrupt`` and ``fault_noise``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.resil import faults as faults_mod

from . import events as events_mod

# per-stream tags of the reference (topo takes 7, resil 8-11, events 1000)
_DROP, _CHURN, _STRAGGLE, _BURST, _BURST_INIT, _TIER = 1, 2, 3, 4, 5, 6


class RoundConditions(NamedTuple):
    """Dense per-round masks, all float32 in {0, 1}."""
    edge_mask: Any       # [n, n] symmetric; 1 = message delivered
    active: Any          # [n]    1 = node online
    straggler: Any       # [n]    1 = node slow this round
    stale: Any = None    # [n]    1 = neighbours see this node's stale
    #                      snapshot (async gossip); None when sync
    crashed: Any = None  # [n]    1 = node crashed (resil's chain, already
    #                      folded into ``active``); None without the chain
    corrupt: Any = None  # [n]    1 = node ships a corrupted payload this
    #                      round (resil); None without corruption
    fault_noise: Any = None  # the round's payload noise, one tensor per
    #                      float leaf of the sent tree (resil, noise mode);
    #                      the reference's ``fault_key``


class ChannelState(NamedTuple):
    """The Gilbert–Elliott state: ``bad [n, n]`` float32 {0, 1},
    symmetric, zero diagonal — 1 where the undirected link is in its bad
    (bursty-loss) state."""
    bad: Any


class NetDraws(NamedTuple):
    """One round's raw draws, as the masks consume them. ``None`` where
    the config does not use the stream."""
    drop: Any            # [n, n] uniforms, _DROP at the round
    churn: Any           # [n] uniforms, _CHURN at the round's outage block
    straggle: Any        # [n] uniforms, _STRAGGLE at the round
    burst: Any = None    # [n, n] uniforms, _BURST at the round (cfg.burst)
    ev_active: Any = None  # [n] float32 events' availability (cfg.events)
    ev_edges: Any = None   # [n, n] float32 events' link mask (cfg.events)
    tiers: Any = None    # [n] int32 node tiers, static (cfg.classes)
    crash: Any = None    # [n] uniforms, resil's tag 8 (crash chain)
    restart: Any = None  # [n] uniforms, resil's tag 9 (crash chain)
    corrupt: Any = None  # [n] uniforms, resil's tag 10 (corruption)
    noise: Any = None    # tuple of normal tensors, tag 11 (noise mode)

    def to(self, device) -> "NetDraws":
        def move(v):
            if isinstance(v, tuple):
                return tuple(t.to(device) for t in v)
            return None if v is None else v.to(device)
        return NetDraws(*(move(v) for v in self))


@dataclasses.dataclass(frozen=True)
class BurstConfig:
    """Gilbert–Elliott two-state Markov link loss.

    Per round and per undirected link: a *good* link goes bad with
    ``p_bad``; a *bad* link recovers with ``p_recover``; messages drop
    with ``drop_good`` / ``drop_bad`` depending on the current state.
    The stationary bad fraction is ``p_bad / (p_bad + p_recover)`` and bad
    bursts last ``1 / p_recover`` rounds in expectation.
    """
    p_bad: float = 0.05
    p_recover: float = 0.5
    drop_good: float = 0.0
    drop_bad: float = 1.0

    def stationary_bad(self) -> float:
        return self.p_bad / max(self.p_bad + self.p_recover, 1e-12)

    def stationary_drop(self) -> float:
        pi = self.stationary_bad()
        return (1.0 - pi) * self.drop_good + pi * self.drop_bad


@dataclasses.dataclass(frozen=True)
class LinkClasses:
    """Heterogeneous node tiers: a fast ``core`` and a slow ``edge`` class.

    The tier of each node is seeded and static per ``(cfg.seed, n)``
    (:func:`node_tiers`); a link runs at its worse endpoint — pairwise
    latency is the max, bandwidth the min, of the endpoints' class values
    (:func:`repro_torch.netsim.timing.link_matrices`).
    """
    edge_fraction: float = 0.5
    core_latency_s: float = 1e-3
    edge_latency_s: float = 8e-2
    core_bandwidth_bps: float = 1e9
    edge_bandwidth_bps: float = 2e7


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Static description of the simulated network.

    Presets (``NetworkConfig.preset(name)``, :data:`PRESETS`): ``ideal``
    (the free perfect medium), ``lan``, ``wan``, ``edge-churn``,
    ``hostile``, and the bursty, tiered and asynchronous ``bursty-wan``,
    ``core-edge``, ``async-edge`` and ``edge-v2``.
    """
    name: str = "custom"
    drop_rate: float = 0.0           # P(a link loses this round's message)
    churn_rate: float = 0.0          # P(node offline in an outage block)
    outage_rounds: int = 2           # length of one offline stretch (rounds)
    straggler_rate: float = 0.0      # P(node is slow this round)
    straggler_slowdown: float = 4.0  # compute/link time multiplier when slow
    latency_s: float = 1e-3          # per-link one-way latency (seconds)
    bandwidth_bps: float = 1e9       # per-link bandwidth (bits per second)
    compute_s_per_step: float = 0.05  # seconds per local SGD step (sim scale)
    seed: int = 0                    # netsim's own stream, independent of
    #                                  the experiment seed
    events: tuple = ()               # round-indexed scenario (events.py)
    burst: "BurstConfig | None" = None    # Gilbert–Elliott bursty loss;
    #                                  None keeps the i.i.d. drop_rate coin
    classes: "LinkClasses | None" = None  # core/edge link tiers; None keeps
    #                                  the uniform latency_s/bandwidth_bps
    async_gossip: bool = False       # stragglers serve stale snapshots
    #                                  instead of stretching the round
    max_staleness: int = 3           # max rounds a straggler may lag; 0
    #                                  makes async_gossip the sync path
    faults: Any = None               # resil.FaultConfig | None: node
    #                                  crashes, restarts and payload
    #                                  corruption (frozen: a cache key too)

    @classmethod
    def preset(cls, name: str, **overrides) -> "NetworkConfig":
        if name not in PRESETS:
            raise ValueError(
                f"unknown netsim preset {name!r}; know {sorted(PRESETS)}")
        kw = dict(PRESETS[name])
        kw.update(overrides)
        return cls(name=name, **kw)


PRESETS: dict[str, dict] = {
    # the free, instantaneous, perfectly reliable medium
    "ideal": dict(drop_rate=0.0, churn_rate=0.0, straggler_rate=0.0,
                  latency_s=0.0, bandwidth_bps=1e15),
    # one rack: fast links, the odd busy machine
    "lan": dict(drop_rate=0.0, churn_rate=0.0, straggler_rate=0.05,
                straggler_slowdown=2.0, latency_s=5e-4, bandwidth_bps=10e9),
    # cross-datacenter gossip
    "wan": dict(drop_rate=0.01, churn_rate=0.02, straggler_rate=0.10,
                straggler_slowdown=4.0, latency_s=5e-2, bandwidth_bps=1e8),
    # flaky phones/hospital workstations joining and leaving
    "edge-churn": dict(drop_rate=0.05, churn_rate=0.20, outage_rounds=3,
                       straggler_rate=0.20, straggler_slowdown=6.0,
                       latency_s=8e-2, bandwidth_bps=2e7),
    # stress test for cluster-assignment stability
    "hostile": dict(drop_rate=0.25, churn_rate=0.35, outage_rounds=4,
                    straggler_rate=0.30, straggler_slowdown=10.0,
                    latency_s=2e-1, bandwidth_bps=5e6),
    # cross-datacenter gossip whose loss comes in bursts, not i.i.d. coins
    "bursty-wan": dict(churn_rate=0.02, straggler_rate=0.10,
                       straggler_slowdown=4.0, latency_s=5e-2,
                       bandwidth_bps=1e8,
                       burst=BurstConfig(p_bad=0.15, p_recover=0.5,
                                         drop_good=0.005, drop_bad=0.9)),
    # fast datacenter core + slow edge devices: per-link latency/bandwidth
    "core-edge": dict(drop_rate=0.02, straggler_rate=0.15,
                      straggler_slowdown=4.0,
                      classes=LinkClasses(edge_fraction=0.5,
                                          core_latency_s=1e-3,
                                          edge_latency_s=8e-2,
                                          core_bandwidth_bps=1e9,
                                          edge_bandwidth_bps=2e7)),
    # flaky edge fleet where stragglers gossip stale updates asynchronously
    "async-edge": dict(drop_rate=0.05, churn_rate=0.10, outage_rounds=3,
                       straggler_rate=0.25, straggler_slowdown=6.0,
                       latency_s=8e-2, bandwidth_bps=2e7,
                       async_gossip=True, max_staleness=3),
    # everything at once: bursty links, core/edge tiers, async stale gossip
    "edge-v2": dict(churn_rate=0.10, outage_rounds=3, straggler_rate=0.25,
                    straggler_slowdown=6.0,
                    burst=BurstConfig(p_bad=0.10, p_recover=0.4,
                                      drop_good=0.01, drop_bad=0.8),
                    classes=LinkClasses(edge_fraction=0.5,
                                        core_latency_s=1e-3,
                                        edge_latency_s=8e-2,
                                        core_bandwidth_bps=1e9,
                                        edge_bandwidth_bps=2e7),
                    async_gossip=True, max_staleness=3),
}


# ---------------------------------------------------------------- draws --
def _generator(seed: int, tag: int, index: int, *more) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(tag), int(index),
                                    *map(int, more)])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


class CounterDraws:
    """The port's netsim stream: each ``(seed, tag, index)`` seeds its own
    CPU generator, so a draw depends on nothing else. ``TorchDraws``
    hands its netsim draws here; it is also the default source of
    :func:`repro_torch.netsim.channel_stats`."""

    def net_uniform(self, seed: int, tag: int, index: int, shape):
        """float32 uniforms in [0, 1) of ``shape``, on the CPU."""
        return torch.rand(tuple(shape), generator=_generator(seed, tag,
                                                             index))

    def net_randint(self, seed: int, tag: int, index: int, shape,
                    high: int):
        """int64 integers in [0, high) of ``shape``, on the CPU."""
        return torch.randint(0, int(high), tuple(shape),
                             generator=_generator(seed, tag, index))

    def net_normal(self, seed: int, tag: int, index: int, leaf: int,
                   shape):
        """float32 standard normals of ``shape``, on the CPU, from a
        generator of their own per ``(seed, tag, index, leaf)``."""
        return torch.randn(tuple(shape),
                           generator=_generator(seed, tag, index, leaf))


class NetSchedule:
    """The host side of one run's network: ``round(rnd)`` draws round
    ``rnd``'s :class:`NetDraws` on the CPU from ``source`` (which has
    ``net_uniform``/``net_randint``, and ``net_normal`` for payload
    noise); the node tiers and the channel's initial uniforms are drawn
    once, here. Both drivers draw through one of these, so they consume
    the same uniforms. ``noise``: the payload noise's layout
    (``resil.noise_spec``), needed iff the faults corrupt in noise
    mode."""

    def __init__(self, cfg: NetworkConfig, n: int, source, noise=None):
        self.cfg, self.n, self.source = cfg, n, source
        self.noise = noise if faults_mod.needs_noise(cfg) else None
        self.tiers = None
        if cfg.classes is not None:
            self.tiers = node_tiers(cfg, n, source.net_uniform(
                cfg.seed, _TIER, 0, (n,)))
        self.channel_uniform = None
        if cfg.burst is not None:
            self.channel_uniform = source.net_uniform(cfg.seed, _BURST_INIT,
                                                      0, (n, n))

    def init_channel(self, device) -> "ChannelState | None":
        """The run's initial channel on ``device`` (``None`` without
        bursty loss)."""
        if self.channel_uniform is None:
            return None
        return init_channel(self.cfg, self.channel_uniform.to(device))

    def round(self, rnd: int) -> NetDraws:
        cfg, n, src = self.cfg, self.n, self.source
        block = rnd // max(1, cfg.outage_rounds)
        burst = ev_active = ev_edges = None
        if cfg.burst is not None:
            burst = src.net_uniform(cfg.seed, _BURST, rnd, (n, n))
        if cfg.events:
            ev_active, ev_edges = events_mod.event_masks(
                cfg.seed, cfg.events, n, rnd, src)
        faults = faults_mod.faults_of(cfg)
        crash = restart = corrupt = noise = None
        if faults is not None and faults.crash_rate > 0:
            crash = src.net_uniform(cfg.seed, faults_mod.CRASH, rnd, (n,))
            restart = src.net_uniform(cfg.seed, faults_mod.RESTART, rnd,
                                      (n,))
        if faults is not None and faults.corrupt_rate > 0:
            corrupt = src.net_uniform(cfg.seed, faults_mod.CORRUPT, rnd,
                                      (n,))
        if faults_mod.needs_noise(cfg):
            if self.noise is None:
                raise ValueError("payload noise (corrupt_mode='noise') "
                                 "needs the sent tree's layout: build the "
                                 "schedule with noise=resil.noise_spec(...)")
            noise = faults_mod.draw_noise(src, cfg.seed, rnd, self.noise)
        return NetDraws(
            drop=src.net_uniform(cfg.seed, _DROP, rnd, (n, n)),
            churn=src.net_uniform(cfg.seed, _CHURN, block, (n,)),
            straggle=src.net_uniform(cfg.seed, _STRAGGLE, rnd, (n,)),
            burst=burst, ev_active=ev_active, ev_edges=ev_edges,
            tiers=self.tiers, crash=crash, restart=restart, corrupt=corrupt,
            noise=noise)


# ----------------------------------------------------------- the masks --
def _sym_uniform(u):
    """One coin per undirected edge (the upper triangle), mirrored to
    ``[n, n]`` with a zero diagonal."""
    upper = torch.triu(u, 1)
    return upper + upper.T


def _off_diagonal(n: int, device):
    return 1.0 - torch.eye(n, device=device)


def init_channel(cfg: "NetworkConfig | None", u):
    """Initial Gilbert–Elliott state from the stationary distribution,
    from the ``_BURST_INIT`` uniforms ``u [n, n]``. ``None`` when bursty
    loss is off."""
    if cfg is None or cfg.burst is None:
        return None
    pi = cfg.burst.stationary_bad()
    bad = (_sym_uniform(u) < pi).to(torch.float32)
    return ChannelState(bad=bad * _off_diagonal(u.shape[0], u.device))


def step_channel(cfg: "NetworkConfig | None", u, chan):
    """Advance every link's chain by one round from the round's
    ``_BURST`` uniforms ``u [n, n]`` (one transition coin per undirected
    edge)."""
    if cfg is None or cfg.burst is None:
        return None
    if chan is None:
        raise ValueError("bursty loss needs the carried channel state: "
                         "start from NetSchedule.init_channel")
    u_sym = _sym_uniform(u)
    stay_bad = u_sym < (1.0 - cfg.burst.p_recover)
    go_bad = u_sym < cfg.burst.p_bad
    bad = torch.where(chan.bad > 0, stay_bad, go_bad).to(torch.float32)
    return ChannelState(bad=bad * _off_diagonal(u.shape[0], u.device))


def node_tiers(cfg: NetworkConfig, n: int, u=None):
    """{0=core, 1=edge} int32 ``[n]`` from the ``_TIER`` uniforms ``u``;
    all-core when ``cfg.classes`` is None."""
    if cfg.classes is None:
        return torch.zeros((n,), dtype=torch.int32)
    return (u < cfg.classes.edge_fraction).to(torch.int32)


def edge_mask(cfg: NetworkConfig, u, chan=None):
    """Symmetric {0,1} ``[n, n]``: 1 where the link delivers this round,
    from the round's ``_DROP`` uniforms ``u``. Without ``cfg.burst`` the
    i.i.d. ``drop_rate`` coin; with it, the drop probability follows the
    Gilbert–Elliott state in ``chan``."""
    u_sym = _sym_uniform(u)
    if cfg.burst is None:
        return (u_sym >= cfg.drop_rate).to(torch.float32)
    if chan is None:
        raise ValueError(
            "bursty loss needs the carried channel state: use "
            "advance_conditions(cfg, draws, chan) with the channel from "
            "NetSchedule.init_channel")
    drop = torch.where(chan.bad > 0, cfg.burst.drop_bad,
                       cfg.burst.drop_good)
    return (u_sym >= drop).to(torch.float32)


def availability(cfg: NetworkConfig, u):
    """{0,1} ``[n]``: node online, from the ``_CHURN`` uniforms of the
    round's outage block."""
    return (u >= cfg.churn_rate).to(torch.float32)


def straggler_mask(cfg: NetworkConfig, u):
    return (u < cfg.straggler_rate).to(torch.float32)


def round_conditions(cfg: NetworkConfig, draws: NetDraws,
                     chan=None) -> RoundConditions:
    """All masks of one round from its draws, the stochastic models
    composed with the scheduled events. ``chan`` is the carried
    :class:`ChannelState`, required iff ``cfg.burst`` is set."""
    edges = edge_mask(cfg, draws.drop, chan)
    active = availability(cfg, draws.churn)
    strag = straggler_mask(cfg, draws.straggle)
    if draws.ev_edges is not None:
        edges = edges * draws.ev_edges
        active = active * draws.ev_active
    return RoundConditions(edge_mask=edges, active=active, straggler=strag)


def advance_conditions(cfg: NetworkConfig, draws: NetDraws, chan=None):
    """Step the bursty channel into the round and draw its masks:
    ``(RoundConditions, new ChannelState-or-None)``. The per-round entry
    point of both drivers: the engine runs it inside the captured round
    with the channel in a static buffer, the loop threads the channel
    through Python."""
    chan = step_channel(cfg, draws.burst, chan)
    return round_conditions(cfg, draws, chan), chan
