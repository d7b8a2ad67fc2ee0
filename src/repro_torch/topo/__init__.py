"""repro_torch.topo — adaptive, netsim-aware topology policies with a
fairness floor, the port of ``repro.topo``.

Instead of sampling every round's gossip graph blind
(``core/topology.py``'s uniform r-regular draw), a
:class:`~.policy.TopoConfig` makes the sampler a carried, learned policy
on the device: per-link EWMAs of observed delivery and link seconds
(:class:`~.policy.TopoState`, in the engine's carry beside the netsim
channel and gossip buffer) drive Gumbel-top-k sampling toward reliable or
fast links, while a ``min_inclusion`` participation floor keeps edge-tier
nodes throttled, never starved. Each round's draws (the participation
uniforms and the Gumbel noise, :class:`~.policy.TopoDraw`) come from the
run's draws source on the host.

Usage, any algorithm, any netsim preset, either driver::

    from repro_torch.core.runner import run_experiment
    from repro_torch.netsim import NetworkConfig
    from repro_torch.topo import TopoConfig

    res = run_experiment("facade", cfg, ds, rounds=100,
                         net=NetworkConfig.preset("core-edge"),
                         topo=TopoConfig(policy="reliability",
                                         min_inclusion=0.2))

``topo=None`` and ``TopoConfig(policy="uniform")`` are the run without a
policy bit for bit, for the five algorithms on both drivers;
``TopoConfig`` is an ``EngineSpec`` field, so every field forks the cache
key.
"""
from .diagnostics import inclusion_stats  # noqa: F401
from .policy import (POLICIES, TOPO_STREAM, CounterDraws,  # noqa: F401
                     TopoConfig, TopoDraw, TopoState, adaptive, advance,
                     budget, counter_draw, gumbel_graph, gumbel_of,
                     init_state, link_logits, link_scores, participants,
                     participation_probs, sample, static_draw)
