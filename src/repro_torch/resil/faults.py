"""Node faults: crashes, restarts and payload corruption, and the robust
aggregation guard's primitives. The port of ``repro.resil.faults``.

netsim stresses the *links*; this module stresses the *nodes*. A node can
crash and stay down for a random number of rounds (a two-state chain per
node, the node analogue of the Gilbert–Elliott link channel), come back
with the state it crashed with (``rejoin-stale``) or reset to its round-0
state (``reset``), and a live node can ship a corrupted payload
(additive noise, a blown-up scale, or NaNs) to every neighbour for a
round.

Semantics, composed through netsim's contracts:

* a crashed node is ``active == 0`` for the round, so
  ``topology.effective_adjacency`` zeroes its rows and columns (0 bytes)
  and ``netsim.round_time`` leaves it out of the gating set;
* a corrupting node stays active: its payload is mangled in
  :func:`corrupt_view` (composed with the async stale view by
  ``netwire.sent_view``), its own state is untouched;
* the guard (:func:`guard_of`, ``bindings.gossip_mix(guard=...)``)
  quarantines non-finite senders and norm-clips the rest. It is off
  unless ``robust`` is set and ``corrupt_rate > 0``, so every zero-rate
  off-switch keeps the fault-free arithmetic bit for bit.

**Draws are inputs.** The reference draws the chain's and the corruption's
uniforms, and the payload noise, from the counter stream of the network's
seed inside :func:`advance` and :func:`corrupt_view`. Here the round's
``netsim.NetDraws`` carries them (``crash``, ``restart``, ``corrupt``
``[n]`` uniforms, tags 8, 9 and 10; ``noise``, one normal tensor per
float leaf of the sent tree, tag 11), drawn on the host by
``netsim.NetSchedule`` from the run's draws source, so both drivers
consume identical draws. Every branch here is decided by the static
:class:`FaultConfig`, never by a device value, so a round that runs these
functions can be captured in a CUDA graph.

**Leaf numbering.** The reference numbers the sent tree's leaves in
``jax.tree.flatten`` order: dict keys sorted at every level, integer
leaves counted although never corrupted (FACADE's ``cluster_id`` is leaf
0). :func:`payload_leaves` gives that order for the port's trees, and
each noise leaf is drawn in the reference's layout (HWIO for a conv
kernel) and moved to the port's (OIHW), so a source that replays the
reference's stream gives the reference's noise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

# counter-stream tags of the reference (netsim takes 1-6, topo 7, events
# 1000)
CRASH, RESTART, CORRUPT, PAYLOAD = 8, 9, 10, 11

RESTART_MODES = ("rejoin-stale", "reset")
CORRUPT_MODES = ("noise", "scale", "nan")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static node-fault model. Lives on ``NetworkConfig.faults``, so every
    field forks the ``EngineSpec`` cache key through its ``net``.

    Crash chain (per node, per round): an up node goes down with
    ``crash_rate``; a down node comes back with ``restart_rate`` (outages
    last ``1 / restart_rate`` rounds in expectation). ``restart_mode``
    says what a restarted node rejoins with: the state it crashed with
    (``rejoin-stale``) or its round-0 state (``reset``).

    Corruption (per live node, per round, rate ``corrupt_rate``): the
    node's outgoing payload, never its own state, is mangled per
    ``corrupt_mode``: ``noise`` adds ``corrupt_scale`` times standard
    normal noise, ``scale`` multiplies by ``corrupt_scale``, ``nan``
    poisons every float leaf. ``robust`` and ``clip`` configure the
    receivers' guard: non-finite payloads are quarantined and finite ones
    norm-clipped to ``clip`` times the receiver's own norm.
    """
    crash_rate: float = 0.0
    restart_rate: float = 0.5
    restart_mode: str = "rejoin-stale"
    corrupt_rate: float = 0.0
    corrupt_mode: str = "noise"
    corrupt_scale: float = 100.0
    robust: bool = True
    clip: float = 3.0

    def __post_init__(self):
        if self.restart_mode not in RESTART_MODES:
            raise ValueError(f"restart_mode must be one of {RESTART_MODES}, "
                             f"got {self.restart_mode!r}")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"corrupt_mode must be one of {CORRUPT_MODES}, "
                             f"got {self.corrupt_mode!r}")
        for name in ("crash_rate", "restart_rate", "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.clip <= 0:
            raise ValueError(f"clip must be > 0, got {self.clip}")


class FaultState(NamedTuple):
    """The crash chain's carried state (``None`` in the carry whenever
    ``crash_rate == 0``: corruption alone is memoryless)."""
    down: Any            # [n] float32 {0, 1}: 1 = node is down this round
    init: Any = None     # copy of the round-0 state (restart_mode="reset")


def faults_of(net) -> "FaultConfig | None":
    """The run's fault model, ``None`` without ``net`` or ``net.faults``."""
    return None if net is None else net.faults


def guard_of(fcfg: "FaultConfig | None") -> "FaultConfig | None":
    """The guard to hand ``bindings.gossip_mix``: not ``None`` only when
    payloads can be corrupted and the config asks for robustness (its row
    renormalisation would perturb honest runs' bits)."""
    if fcfg is None or not fcfg.robust or fcfg.corrupt_rate <= 0:
        return None
    return fcfg


def needs_noise(net) -> bool:
    """Whether a round draws payload noise: corruption on, in noise mode."""
    fcfg = faults_of(net)
    return (fcfg is not None and fcfg.corrupt_rate > 0
            and fcfg.corrupt_mode == "noise")


def _map(fn, *trees):
    """``fn`` over the tensors of parallel trees (dicts and named tuples,
    such as an algorithm state); anything else (the host round counter,
    ``None``) passes through from the last tree."""
    head = trees[-1]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, tuple) and hasattr(head, "_fields"):
        return type(head)(*(_map(fn, *parts) for parts in zip(*trees)))
    if torch.is_tensor(head):
        return fn(*trees)
    return head


def _device_of(tree):
    found = []
    _map(lambda t: found.append(t.device), tree)
    return found[0] if found else torch.device("cpu")


def init_state(net, n: int, state=None) -> "FaultState | None":
    """The run's :class:`FaultState` (``None`` when the crash chain is
    off), on the device of ``state``, the run's initial algorithm state
    (the CPU without one). Under ``reset`` a copy of ``state`` is kept to
    restore restarted nodes from; a copy, so it never aliases the
    training state."""
    fcfg = faults_of(net)
    if fcfg is None or fcfg.crash_rate <= 0:
        return None
    init = None
    if fcfg.restart_mode == "reset":
        if state is None:
            raise ValueError('restart_mode="reset" needs the initial '
                             "algorithm state to restore nodes from")
        init = _map(torch.clone, state)
    dev = torch.device("cpu") if state is None else _device_of(state)
    return FaultState(down=torch.zeros((n,), dtype=torch.float32,
                                       device=dev), init=init)


def advance(net, n: int, conds, fstate, draws):
    """The per-round fault hook of both drivers, right after
    ``netsim.advance_conditions`` and before ``apply_async``, from the
    round's ``draws`` (a ``netsim.NetDraws``).

    Returns ``(conds', fstate', restarted)``: the conditions with crashed
    nodes folded into ``active`` (and the round's ``crashed`` and
    ``corrupt`` masks and ``fault_noise``), the advanced chain, and, under
    ``restart_mode="reset"`` only, the {0,1} mask of the nodes restarting
    this round (the driver then applies :func:`reset_nodes` before the
    round; ``None`` means nothing to reset). No faults: everything passes
    through."""
    fcfg = faults_of(net)
    if fcfg is None or conds is None:
        return conds, fstate, None
    restarted = None
    if fcfg.crash_rate > 0:
        was_down = fstate.down > 0
        come_up = draws.restart < fcfg.restart_rate
        down = torch.where(was_down, ~come_up,
                           draws.crash < fcfg.crash_rate).to(torch.float32)
        conds = conds._replace(active=conds.active * (1.0 - down),
                               crashed=down)
        if fcfg.restart_mode == "reset":
            restarted = (was_down & come_up).to(torch.float32)
        fstate = fstate._replace(down=down)
    if fcfg.corrupt_rate > 0:
        # crashed and churned-out nodes deliver nothing: only live senders
        # corrupt, so the masks stay disjoint
        corrupt = (draws.corrupt < fcfg.corrupt_rate).to(torch.float32)
        conds = conds._replace(corrupt=corrupt * conds.active,
                               fault_noise=draws.noise)
    return conds, fstate, restarted


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def reset_nodes(n: int, restarted, init, state):
    """Reset the restarting nodes: every node-stacked tensor of ``state``
    (leading axis ``n``) takes its round-0 value from ``init`` where
    ``restarted == 1``. Scalars, host numbers (the round counter), tensors
    whose leading axis is not ``n`` and unsigned ones pass through."""
    def pick(i, s):
        if s.dim() < 1 or s.shape[0] != n or s.dtype in _UNSIGNED:
            return s
        m = restarted.reshape((n,) + (1,) * (s.dim() - 1))
        return torch.where(m > 0, i, s).to(s.dtype)

    return _map(pick, init, state)


# ------------------------------------------------------ payload corruption
def payload_leaves(tree) -> list:
    """``[(path, leaf)]`` of a nested dict in ``jax.tree.flatten`` order
    (keys sorted at every level), integer leaves included."""
    if isinstance(tree, dict):
        return [((k,) + path, leaf) for k in sorted(tree)
                for path, leaf in payload_leaves(tree[k])]
    return [((), tree)]


def _conv_axes(ndim: int, lead: int):
    """A conv kernel (``lead + 4`` dims): the reference's ``[..., H, W, I,
    O]`` to the port's ``[..., O, I, H, W]`` as ``movedim`` arguments, as
    ``repro_torch.interop.params_from_jax`` moves them; ``None`` for any
    other leaf."""
    if ndim != lead + 4:
        return None
    return (lead + 2, lead + 3), (lead + 1, lead)


def _lead(lead, path) -> int:
    return lead.get(path[0], 1) if isinstance(lead, dict) else lead


def noise_spec(net, tree, lead=1):
    """What a round's payload noise is, for ``netsim.NetSchedule``:
    ``((leaf_index, shape in the reference's layout, conv movedim or
    None), ...)`` for each float leaf of the sent ``tree`` in
    :func:`payload_leaves` order (``leaf_index`` counts the integer
    leaves too). ``lead``: the stacked axes in front of each model leaf,
    an int or a dict by top-level key (FACADE's heads have two, ``[n,
    k]``). ``None`` when the run draws no noise."""
    if not needs_noise(net):
        return None
    spec = []
    for i, (path, leaf) in enumerate(payload_leaves(tree)):
        if not leaf.is_floating_point():
            continue
        axes = _conv_axes(leaf.dim(), _lead(lead, path))
        shape = tuple(leaf.shape)
        if axes is not None:          # the port's OIHW back to HWIO
            ld = _lead(lead, path)
            shape = shape[:ld] + shape[ld + 2:] + (shape[ld + 1],
                                                   shape[ld])
        spec.append((i, shape, axes))
    return tuple(spec)


def draw_noise(source, seed: int, rnd: int, spec) -> tuple:
    """Round ``rnd``'s noise leaves from ``source.net_normal`` (tag 11, the
    leaf index folded in), each in the port's layout, on the CPU."""
    out = []
    for index, shape, axes in spec:
        z = source.net_normal(seed, PAYLOAD, rnd, index, shape)
        if axes is not None:
            z = z.movedim(*axes).contiguous()
        out.append(z)
    return tuple(out)


def corrupt_view(fcfg: FaultConfig, conds, tree):
    """Mangle the node-stacked payload ``tree`` along its leading axis
    where ``conds.corrupt == 1``. Float leaves only (cluster ids ship
    uncorrupted); in noise mode the float leaves take
    ``conds.fault_noise``'s tensors in :func:`payload_leaves` order."""
    mask = conds.corrupt
    noise = iter(conds.fault_noise if conds.fault_noise is not None
                 else ())
    out = {}
    for path, leaf in payload_leaves(tree):
        if not leaf.is_floating_point():
            continue
        if fcfg.corrupt_mode == "noise":
            bad = leaf + (fcfg.corrupt_scale * next(noise)).to(leaf.dtype)
        elif fcfg.corrupt_mode == "scale":
            # the scale rounded to the leaf's dtype, as the reference
            scale = torch.tensor(fcfg.corrupt_scale, dtype=leaf.dtype)
            bad = leaf * float(scale)
        else:  # "nan"
            bad = leaf * math.nan
        m = mask.reshape((mask.shape[0],) + (1,) * (leaf.dim() - 1))
        out[path] = torch.where(m > 0, bad, leaf).to(leaf.dtype)
    return _rebuild(tree, out)


def _rebuild(tree, new: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, path + (k,)) for k, v in tree.items()}
    return new.get(path, tree)


# ------------------------------------------------- robust-guard primitives
def _float_leaves(tree) -> list:
    return [leaf for _, leaf in payload_leaves(tree)
            if leaf.is_floating_point()]


def node_finite(tree):
    """[n] float32: 1 where every float leaf of the node is finite (the
    quarantine predicate; integer leaves carry no poison)."""
    ok = None
    for leaf in _float_leaves(tree):
        fin = torch.isfinite(leaf.float().reshape(leaf.shape[0], -1)
                             ).all(dim=1).to(torch.float32)
        ok = fin if ok is None else ok * fin
    if ok is None:
        raise ValueError("node_finite needs at least one float leaf")
    return ok


def node_norm(tree):
    """[n] float32: each node's L2 norm over its float leaves (NaN or inf
    for a poisoned node: callers mask with :func:`node_finite`)."""
    sq = None
    for leaf in _float_leaves(tree):
        s = leaf.float().square().reshape(leaf.shape[0], -1).sum(dim=1)
        sq = s if sq is None else sq + s
    if sq is None:
        raise ValueError("node_norm needs at least one float leaf")
    return torch.sqrt(sq)


def quarantined_count(guard, delivered, device=None):
    """float32 0-d tensor: the senders the guard quarantined this round (0
    when the guard is off or nothing was delivered), on ``device`` (or
    ``delivered``'s). A device value: no driver reads it back a round."""
    if guard is None or delivered is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    return (1.0 - node_finite(delivered)).sum()

