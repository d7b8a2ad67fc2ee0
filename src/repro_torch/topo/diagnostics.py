"""Empirical diagnostics over the adaptive topology sampler, the port of
``repro.topo.diagnostics``.

The fairness floor claims that every node participates in at least
``min_inclusion`` of the rounds however the learned scores rank it; tests
and the card's smoke run check that against measured behaviour, as
``netsim.channel_stats`` measures the bursty channel.
:func:`inclusion_stats` rolls the drivers' own per-round path (each
round: ``netsim.advance_conditions``, then :func:`~.policy.sample`, then
:func:`~.policy.advance`) on the device and reduces it on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import netsim

from . import policy as policy_mod


def inclusion_stats(cfg, net, n: int, rounds: int, degree: int,
                    seed: int = 0, draws=None, device="cuda") -> dict:
    """Roll the adaptive sampler for ``rounds`` rounds on ``device`` and
    measure it.

    ``draws`` supplies the netsim uniforms (``net_uniform``) and each
    round's sampler draw, ``draws.policy_draw_at(seed, None, rnd, n)``,
    the reference's ``fold_in(PRNGKey(seed), rnd)`` (default
    :class:`~.policy.CounterDraws`, the port's own streams). Returns the
    per-node ``inclusion`` frequency (the share of rounds with degree >=
    1), the ``participation`` frequency (the sampler's coin, which the
    floor bounds), the mean and largest degree, the mean undirected edge
    count a round, the ``edge_budget`` and the flags ``symmetric`` and
    ``binary`` over every drawn adjacency. ``cfg`` must be adaptive."""
    if not policy_mod.adaptive(cfg):
        raise ValueError("inclusion_stats needs an adaptive TopoConfig "
                         "(policy 'reliability' or 'bandwidth')")
    dev = device_mod.resolve(device)
    source = draws if draws is not None else policy_mod.CounterDraws()
    r = policy_mod.budget(cfg, degree)
    state = policy_mod.init_state(cfg, net, n, dev)
    sched = chan = None
    if net is not None:
        sched = netsim.NetSchedule(net, n, source)
        chan = sched.init_channel(dev)
    adjs, parts = [], []
    for rnd in range(rounds):
        conds = tiers = None
        if net is not None:
            drawn = sched.round(rnd).to(dev)
            conds, chan = netsim.advance_conditions(net, drawn, chan)
            tiers = drawn.tiers
        d = source.policy_draw_at(seed, None, rnd, n).to(dev)
        parts.append(policy_mod.participants(cfg, state, d.u))
        adjs.append(policy_mod.sample(cfg, state, d.u, d.gumbel, n, r))
        state = policy_mod.advance(cfg, net, state, conds, tiers)
    adjs = torch.stack(adjs).cpu().numpy()
    parts = torch.stack(parts).cpu().numpy()

    deg = adjs.sum(axis=2)                                  # [rounds, n]
    return {
        "inclusion": (deg > 0).mean(axis=0),                # [n]
        "participation": parts.mean(axis=0),                # [n]
        "mean_degree": float(deg.mean()),
        "max_degree": float(deg.max()),
        "mean_edges": float(adjs.sum(axis=(1, 2)).mean() / 2.0),
        "edge_budget": n * max(1, r // 2),
        "symmetric": bool((adjs == np.swapaxes(adjs, 1, 2)).all()),
        "binary": bool(set(np.unique(adjs)) <= {0.0, 1.0}),
    }
