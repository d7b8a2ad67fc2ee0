"""repro_torch.netsim — network-condition simulation for decentralized
learning, the port of ``repro.netsim``.

The round functions model gossip over a free, instantaneous, perfectly
reliable medium unless given a round's conditions. This package makes the
medium a simulated object, so every algorithm (FACADE and the four
baselines) runs under realistic conditions with no per-algorithm fork:

* :mod:`.conditions` — ``NetworkConfig`` and its nine presets, and the
  per-round edge-drop, churn and straggler masks, the Gilbert–Elliott
  bursty channel and the core/edge node tiers, from host-drawn uniforms
  (``NetSchedule``);
* :mod:`.timing` — a latency/bandwidth cost model turning per-round bytes
  and the effective topology into simulated seconds;
* :mod:`.events` — seeded round-indexed scenarios (``BurstFailure``,
  ``Partition``);
* :mod:`.gossip` — asynchronous stale gossip (the staleness buffer);
* :mod:`.diagnostics` — ``channel_stats``, the channel measured.

Usage::

    from repro_torch.core.runner import run_experiment
    from repro_torch.netsim import NetworkConfig

    res = run_experiment("facade", cfg, ds, rounds=100,
                         net=NetworkConfig.preset("edge-churn"))
    res.comm.total_gb         # traffic actually delivered
    res.comm.total_hours      # simulated wall-clock to get there

``net=None`` (the default) is the ideal-medium code path; ``net=
NetworkConfig.preset("ideal")`` runs the netsim path with all-ones masks
and the same training trajectory (its bytes count the directed edges that
carried a message, not the nominal ``n * degree``).
"""
from .conditions import (BurstConfig, ChannelState, CounterDraws,  # noqa: F401
                         LinkClasses, NetDraws, NetSchedule, NetworkConfig,
                         PRESETS, RoundConditions, advance_conditions,
                         availability, edge_mask, init_channel, node_tiers,
                         round_conditions, step_channel, straggler_mask)
from .diagnostics import channel_stats  # noqa: F401
from .events import BurstFailure, Partition, event_masks  # noqa: F401
from .gossip import (GossipState, apply_async, fold_gossip,  # noqa: F401
                     init_gossip, stale_mask, tree_select)
from .timing import link_matrices, link_seconds, round_time  # noqa: F401
