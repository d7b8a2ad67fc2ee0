"""Adaptive, netsim-aware topology policies with a fairness floor, the port
of ``repro.topo.policy``.

``core/topology.py`` draws every round's graph blind: a uniform r-regular
sample spends its degree budget on links the network simulation knows
are bursty, slow or churned out. This module makes graph sampling a
carried, learned policy on the device:

* :class:`TopoConfig` — the frozen, hashable policy (a field of the
  ``EngineSpec`` cache key). ``policy="uniform"`` is the default: the
  algorithm's own sampler runs bit for bit (the round functions never
  call this module's sampler), and nothing rides in the carry.
* :class:`TopoState` — per-link EWMAs of observed *delivery* (from the
  round's edge and churn masks, which fold in the Gilbert–Elliott channel
  and the event schedules) and observed *link seconds* (the
  straggler-stretched transfer time of a reference payload). It rides in
  the engine's carry (static buffers) beside the channel and the gossip
  buffer, and :func:`advance` folds one round into it; both drivers call
  the same functions.
* :func:`sample` — the next round's graph by Gumbel-top-k over the link
  scores. Each *participating* node picks ``max(1, r // 2)`` peers by
  score (union-symmetrised, the DAC idiom), so the graph never spends more
  than the uniform draw's edge budget. A node's participation
  probability scales with its link quality but is clamped to
  ``>= min_inclusion``, so edge-tier nodes are throttled, never starved.

Observation model: the EWMAs observe the round's *conditions* (the masks
exist for every pair in simulation), not just the drawn links, which keeps
:func:`advance` independent of the sampled graph. Scores:

* ``reliability``: ``delivery / link_s``, delivered payload per simulated
  second;
* ``bandwidth``: ``1 / link_s``, speed alone.

**Draws are inputs.** The reference splits a PRNG key into the
participation coin's key and the Gumbel noise's key. Here a round's draw
is a :class:`TopoDraw` (``u [n]`` uniforms, ``gumbel [n, n]``), made on
the host by the run's draws source: FACADE, EL and DAC take it from the
source's topology stream where the reference splits the state's key; the
ring baselines, which have no per-round key, take
``source.policy_draw_at(cfg.seed, TOPO_STREAM, round, n)``, the
reference's ``static_key`` (:func:`static_draw`). :class:`CounterDraws`
is the port's own counter stream for those.

This module imports no part of ``repro_torch.core`` (the round functions
import it), only torch and :mod:`repro_torch.netsim`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import netsim

POLICIES = ("uniform", "reliability", "bandwidth")

_EPS = 1e-6
_NEG = -1e9
TOPO_STREAM = 7      # the reference's fold_in tag of the ring baselines'
#                      sampling stream (netsim takes 1-6, resil 8-11)


@dataclasses.dataclass(frozen=True)
class TopoConfig:
    """The static topology policy (an ``EngineSpec`` field: every field
    here forks the cache key).

    ``degree`` overrides the run's degree budget when set (``None``
    inherits ``run_experiment(degree=...)``); ``min_inclusion`` is the
    fairness floor, a per-round, per-node participation probability held
    whatever the learned scores; ``ref_payload_bytes`` is the message
    size the link-time EWMA observes; ``seed`` drives the sampling stream
    of the algorithms whose own topology is static (the ring baselines).
    """
    policy: str = "uniform"
    decay: float = 0.8               # EWMA weight on history
    degree: "int | None" = None      # degree budget (None -> run degree)
    min_inclusion: float = 0.1       # fairness floor on participation
    ref_payload_bytes: float = 1e6   # payload for link-time observations
    seed: int = 0                    # stream for static-topology algos

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown topology policy {self.policy!r}; know {POLICIES}")
        if not 0.0 <= self.min_inclusion <= 1.0:
            raise ValueError(
                f"min_inclusion must be in [0, 1], got {self.min_inclusion}")
        if not 0.0 <= self.decay < 1.0:
            raise ValueError(
                f"decay must be in [0, 1), got {self.decay}")


class TopoState(NamedTuple):
    """The policy's state on the device (symmetric ``[n, n]`` float32, zero
    diagonal), in the engine's carry or threaded through the loop."""
    delivery: Any    # EWMA of observed per-link delivery in [0, 1]
    link_s: Any      # EWMA of observed per-link seconds (ref payload)


class TopoDraw(NamedTuple):
    """One round's draws of the sampler: the participation coin's
    uniforms ``u [n]`` and the Gumbel noise ``gumbel [n, n]``, float32."""
    u: Any
    gumbel: Any

    def to(self, device) -> "TopoDraw":
        return TopoDraw(self.u.to(device), self.gumbel.to(device))


def adaptive(cfg: "TopoConfig | None") -> bool:
    """True iff the policy replaces the algorithm's own sampler."""
    return cfg is not None and cfg.policy != "uniform"


def budget(cfg: "TopoConfig | None", degree: int) -> int:
    return degree if cfg is None or cfg.degree is None else cfg.degree


# ---------------------------------------------------------------- draws --
def gumbel_of(u):
    """Standard Gumbel noise ``-log(-log(u))`` from uniforms ``u`` in [0,
    1), clamped below at float32's smallest normal as the reference's
    ``jax.random.gumbel`` draws its uniforms."""
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def counter_draw(seed: int, tag: "int | None", rnd: int, n: int) -> TopoDraw:
    """A round's :class:`TopoDraw` on the CPU from a generator of its own
    per ``(seed, tag, rnd)`` (per ``(seed, rnd)`` when ``tag`` is
    ``None``), so it depends on nothing else and replays after a resume
    with no state to save."""
    words = [int(seed)] + ([] if tag is None else [int(tag)]) + [int(rnd)]
    gen = torch.Generator().manual_seed(int(
        np.random.SeedSequence(words).generate_state(1, np.uint64)[0]))
    u = torch.rand((n,), generator=gen)
    return TopoDraw(u, gumbel_of(torch.rand((n, n), generator=gen)))


class CounterDraws(netsim.CounterDraws):
    """The port's counter streams: netsim's uniforms and
    :func:`counter_draw`, the default source of :func:`inclusion_stats`."""

    def policy_draw_at(self, seed: int, tag: "int | None", rnd: int,
                       n: int) -> TopoDraw:
        return counter_draw(seed, tag, rnd, n)


def static_draw(cfg: TopoConfig, rnd: int, n: int, source) -> TopoDraw:
    """The sampler's draw at round ``rnd`` for an algorithm whose own
    topology is static (the ring baselines): ``source``'s stream of
    ``(cfg.seed, TOPO_STREAM, rnd)``, so the schedule replays and never
    touches the algorithm's other draws (the reference's ``static_key``)."""
    return source.policy_draw_at(cfg.seed, TOPO_STREAM, rnd, n)


# ---------------------------------------------------------------- state --
def _offdiag(n: int, device):
    return 1.0 - torch.eye(n, device=device)


def _base_link_s(net, n: int, payload: float, tiers, device):
    """Per-link base transfer seconds of the reference payload: the tiered
    matrices when ``net.classes`` is set (from the node ``tiers``), the
    uniform scalar otherwise, ones without netsim (nothing to observe)."""
    if net is None:
        return torch.ones((n, n), dtype=torch.float32, device=device)
    if net.classes is None:
        return torch.full((n, n), netsim.link_seconds(net, payload),
                          dtype=torch.float32, device=device)
    lat, bw = netsim.link_matrices(net, tiers.to(device))
    return (lat + 8.0 * payload / bw).to(torch.float32)


def init_state(cfg: "TopoConfig | None", net, n: int, device="cuda"):
    """A fresh neutral state on ``device`` (``None`` for uniform or off:
    the carry then holds nothing). Neutral: every link starts equally
    deliverable and equally fast; the policy learns tiers and bursts from
    observations, not from the simulator's ground truth."""
    del net                  # the reference's signature; nothing to read
    if not adaptive(cfg):
        return None
    off = _offdiag(n, torch.device(device)).to(torch.float32)
    # two buffers, as the reference (whose carry is donated leaf by leaf)
    return TopoState(delivery=off, link_s=off.clone())


def advance(cfg: "TopoConfig | None", net, state, conds, tiers=None):
    """Fold one round's observed conditions into the EWMAs.

    The per-round entry point of both drivers (``netwire.net_round``),
    called after the round, so round ``t`` is sampled from what was
    observed up to ``t - 1``. ``tiers``: the node tiers
    (``NetDraws.tiers``), needed iff ``net.classes`` is set. A no-op
    without netsim conditions (nothing was observed) or without an
    adaptive policy."""
    if state is None or conds is None or net is None:
        return state
    n = conds.active.shape[0]
    off = _offdiag(n, conds.active.device)
    obs_d = (conds.edge_mask * conds.active[:, None]
             * conds.active[None, :]) * off
    slow = 1.0 + (net.straggler_slowdown - 1.0) * conds.straggler
    pair_slow = torch.maximum(slow[:, None], slow[None, :])
    obs_t = pair_slow * _base_link_s(net, n, cfg.ref_payload_bytes, tiers,
                                     off.device) * off
    d = cfg.decay
    return TopoState(
        delivery=(d * state.delivery + (1.0 - d) * obs_d).to(torch.float32),
        link_s=(d * state.link_s + (1.0 - d) * obs_t).to(torch.float32))


# -------------------------------------------------------------- sampler --
def link_scores(cfg: TopoConfig, state: TopoState):
    """Nonnegative per-link preference ``[n, n]`` (symmetric; the diagonal
    means nothing and is masked before use)."""
    if cfg.policy == "reliability":
        return state.delivery / (state.link_s + _EPS)
    if cfg.policy == "bandwidth":
        return 1.0 / (state.link_s + _EPS)
    raise ValueError(f"policy {cfg.policy!r} has no link scores")


def link_logits(cfg: TopoConfig, state: TopoState, n: int):
    """Log-scores with the diagonal masked, ready for Gumbel-top-k; also
    the term DAC adds to its similarity logits."""
    eye = torch.eye(n, device=state.delivery.device)
    return torch.log(link_scores(cfg, state) + 1e-9) + _NEG * eye


def participation_probs(cfg: TopoConfig, state: TopoState):
    """Per-node participation probability ``[n]``.

    ``p_i = min_inclusion + (1 - min_inclusion) * q_i / max(q)``, ``q_i``
    the node's mean off-diagonal link score. The best-connected node
    always participates, and the floor is exact: ``p_i >= min_inclusion``
    for every node under any score matrix (the all-zero one included,
    where ``q / max(q)`` is 0)."""
    s = link_scores(cfg, state)
    n = s.shape[0]
    q = (s * _offdiag(n, s.device)).sum(dim=1) / max(n - 1, 1)
    qhat = q / torch.clamp(q.max(), min=_EPS)
    p = cfg.min_inclusion + (1.0 - cfg.min_inclusion) * qhat
    return torch.clamp(p, cfg.min_inclusion, 1.0)


def participants(cfg: TopoConfig, state: TopoState, u):
    """{0, 1} ``[n]``: the round's participation coin from its uniforms
    ``u [n]`` (the floor applied)."""
    return (u < participation_probs(cfg, state)).to(torch.float32)


def gumbel_graph(cfg: TopoConfig, state: TopoState, u, gumbel, n: int,
                 kpick: int, extra_logits=None):
    """The participation-gated Gumbel-top-k graph, the one sampling
    pipeline of :func:`sample` and DAC's similarity sampler.

    Each participating node picks ``kpick`` peers by link score (plus the
    caller's logits, DAC's similarity term); the picks are
    union-symmetrised (push-pull exchange) and gated so edges join
    participants alone. The logits add up in the reference's order, in
    float32: link logits, the non-participants' mask, ``extra_logits``,
    the noise. Returns ``(adj, nbr, part)``: the adjacency, the per-row
    picks ``[n, kpick]`` (DAC scores peer losses at them) and the
    participation mask. Non-participants' columns tie at -1e9 (the noise
    is below an ulp there), so where a row has fewer participating peers
    than ``kpick``, ``nbr``'s picks among them may differ from the
    reference's; ``part`` gates every one of them out of ``adj``."""
    part = participants(cfg, state, u)
    logits = link_logits(cfg, state, n) + _NEG * (1.0 - part)[None, :]
    if extra_logits is not None:
        logits = logits + extra_logits
    nbr = torch.topk(logits + gumbel, kpick, dim=1).indices     # [n, kpick]
    rows = torch.arange(n, device=nbr.device)[:, None]
    adj = torch.zeros((n, n), dtype=torch.float32, device=nbr.device)
    # the one made on the device: a Python scalar written into a CUDA
    # tensor by indexing synchronises, which a captured round must not
    adj.index_put_((rows, nbr), torch.ones((), dtype=adj.dtype,
                                           device=adj.device))
    adj = torch.maximum(adj, adj.T)
    return (adj * part[:, None] * part[None, :] * _offdiag(n, adj.device),
            nbr, part)


def sample(cfg: TopoConfig, state: TopoState, u, gumbel, n: int,
           degree: int):
    """One adaptive round graph (adjacency ``[n, n]``, float 0/1) from the
    round's draws.

    Symmetric, zero diagonal, edges only between participants, at most
    ``n * max(1, r // 2)`` undirected edges (never more than the uniform
    r-regular draw spends at any degree), and every participant with a
    participating peer has degree >= 1. Participation probability >=
    ``min_inclusion`` per node and round whatever the scores."""
    r = budget(cfg, degree)
    adj, _, _ = gumbel_graph(cfg, state, u, gumbel, n, max(1, r // 2))
    return adj
