"""Seeded, round-indexed network event schedules, the port of
``repro.netsim.events``.

Stochastic conditions (``conditions.py``) model steady-state weather;
events model *scenarios*: a rack loses power at round 40, the network
partitions into two halves for 30 rounds and heals. Each event's victim set
or camp assignment is drawn once from the stream ``(seed, 1000, event
index)``, not from the round, so the same nodes stay down for the whole
window and the schedule replays identically under a fixed seed.

The round index is a host number here (the drivers draw a round's inputs on
the host), so the window test is a Python comparison and the masks are
made on the host, beside the round's other draws.
"""
from __future__ import annotations

import dataclasses

import torch

_EVENT_TAG = 1000  # keeps event streams disjoint from conditions.py's


@dataclasses.dataclass(frozen=True)
class BurstFailure:
    """A random ``fraction`` of nodes goes dark for rounds
    [start, start + duration)."""
    start: int
    duration: int
    fraction: float


@dataclasses.dataclass(frozen=True)
class Partition:
    """The network splits into ``groups`` random camps for rounds
    [start, start + duration): links across camps drop every message,
    links inside a camp are untouched. Then it heals."""
    start: int
    duration: int
    groups: int = 2


def event_masks(seed: int, events: tuple, n: int, rnd: int, source):
    """``(avail [n], edge_ok [n, n])`` float32 {0,1} masks of round
    ``rnd`` on the CPU, each event's victims or camps drawn from
    ``source`` (``net_uniform``/``net_randint``); all-ones when no event
    window covers the round."""
    avail = torch.ones((n,), dtype=torch.float32)
    edge_ok = torch.ones((n, n), dtype=torch.float32)
    for idx, ev in enumerate(events):
        if not isinstance(ev, (BurstFailure, Partition)):
            raise TypeError(f"unknown netsim event {type(ev).__name__}")
        if not ev.start <= rnd < ev.start + ev.duration:
            continue
        if isinstance(ev, BurstFailure):
            u = source.net_uniform(seed, _EVENT_TAG, idx, (n,))
            avail = avail * (u >= ev.fraction).to(torch.float32)
        else:
            camp = source.net_randint(seed, _EVENT_TAG, idx, (n,),
                                      ev.groups)
            edge_ok = edge_ok * (camp[:, None] == camp[None, :]).to(
                torch.float32)
    return avail, edge_ok
