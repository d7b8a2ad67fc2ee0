"""repro_torch.resil — node faults and the robust gossip that survives
them, the port of ``repro.resil``.

netsim simulates unreliable *links*; :mod:`.faults` simulates unreliable
*nodes*: :class:`FaultConfig` (a crash and restart chain per node, the
restart mode, payload corruption) on ``NetworkConfig.faults``, the carried
:class:`FaultState`, :func:`advance`, the per-round hook both drivers run
after the round's conditions, :func:`corrupt_view` (per-transmission
payload mangling, composed into ``netwire.sent_view``) and the primitives
of the guard behind ``bindings.gossip_mix(guard=...)``: non-finite
senders quarantined and the rest norm-clipped, so one poisoned node costs
its neighbours a contribution instead of their state.

Usage, any algorithm on either driver::

    from repro_torch.core.runner import run_experiment
    from repro_torch.netsim import NetworkConfig
    from repro_torch.resil import FaultConfig

    net = NetworkConfig.preset(
        "edge-v2",
        faults=FaultConfig(crash_rate=0.05, restart_rate=0.5,
                           corrupt_rate=0.05, corrupt_mode="nan"))
    res = run_experiment("facade", cfg, ds, rounds=100, net=net,
                         ckpt="results/run.ckpt.npz")

``faults=None`` and every zero-rate off-switch are the fault-free run
bit for bit, for the five algorithms on both drivers.
"""
from .faults import (CORRUPT_MODES, RESTART_MODES,  # noqa: F401
                     FaultConfig, FaultState, advance, corrupt_view,
                     draw_noise, faults_of, guard_of, init_state,
                     needs_noise, node_finite, node_norm, noise_spec,
                     payload_leaves, quarantined_count, reset_nodes)
