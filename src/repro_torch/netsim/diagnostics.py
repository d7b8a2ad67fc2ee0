"""Empirical diagnostics over the simulated network models, the port of
``repro.netsim.diagnostics``.

The Gilbert–Elliott channel makes claims (stationary loss rate, mean burst
length, symmetric binary masks) that tests want to check against measured
behaviour. :func:`channel_stats` rolls the drivers' own per-round path, a
loop of rounds over :func:`~.conditions.advance_conditions` (on the CPU),
and reduces it to statistics.
"""
from __future__ import annotations

import numpy as np
import torch

from . import conditions as conditions_mod


def channel_stats(cfg, n: int, rounds: int, source=None) -> dict:
    """Roll the bursty channel for ``rounds`` rounds and measure it.

    ``source`` supplies the uniforms (``net_uniform``/``net_randint``;
    default :class:`~.conditions.CounterDraws`, the port's own stream).
    Returns the empirical per-link ``bad_rate`` and ``loss_rate``, the
    ``mean_burst_len`` over completed bad bursts (NaN when none
    completed), ``n_bursts``, and the flags ``symmetric`` / ``binary``
    over every round's edge mask and channel state.
    """
    source = source if source is not None else conditions_mod.CounterDraws()
    sched = conditions_mod.NetSchedule(cfg, n, source)
    chan = sched.init_channel("cpu")
    bads, masks = [], []
    for rnd in range(rounds):
        conds, chan = conditions_mod.advance_conditions(
            cfg, sched.round(rnd), chan)
        bads.append(chan.bad if chan is not None
                    else torch.zeros((n, n), dtype=torch.float32))
        masks.append(conds.edge_mask)
    bads, masks = torch.stack(bads).numpy(), torch.stack(masks).numpy()

    iu = np.triu_indices(n, 1)
    bad_seq = bads[:, iu[0], iu[1]]                    # [rounds, links]
    lost_seq = 1.0 - masks[:, iu[0], iu[1]]

    lengths = []
    for link in bad_seq.T:
        run = 0
        for b in link:
            if b > 0:
                run += 1
            elif run:
                lengths.append(run)
                run = 0
    return {
        "bad_rate": float(bad_seq.mean()),
        "loss_rate": float(lost_seq.mean()),
        "mean_burst_len": float(np.mean(lengths)) if lengths else float("nan"),
        "n_bursts": len(lengths),
        "symmetric": bool((masks == np.swapaxes(masks, 1, 2)).all()
                          and (bads == np.swapaxes(bads, 1, 2)).all()),
        "binary": bool(set(np.unique(masks)) <= {0.0, 1.0}
                       and set(np.unique(bads)) <= {0.0, 1.0}),
    }
