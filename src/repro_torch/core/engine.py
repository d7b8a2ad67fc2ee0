"""Segment engine: the rounds between two evals as CUDA-graph replays.

The counterpart of ``repro.core.engine``. The per-round loop
(``run_experiment(engine=False)``) issues every op of every round from
Python, and at paper scale that issue cost, not the card, sets the pace.
This module runs the same round closures (FACADE's or a baseline's,
``fn(state, batches, *topology) -> (state, info)``) span by span:

* **one captured round per warmup flag**, replayed once per round of a
  segment (FACADE's warmup and main rounds are two graphs, a baseline's
  round one). The reference compiles one scan per ``(length, warmup)``
  because a scan's length is static; capturing one round bounds capture
  time and graph memory whatever ``eval_every`` is;
* the node-stacked state lives in static buffers that the captured round
  overwrites in place at its end (the counterpart of ``donate_argnums``),
  and so do the train arrays the round gathers its batches from;
* **draws stay host-drawn inputs.** The reference samples each round's
  batches inside its scan from a carried PRNG key. Here a segment's L
  rounds are drawn from the run's draws source in the loop's per-stream
  order (batch indices ``[L, n, H, B]``, then FACADE's and EL's
  permutations ``[L, n_perms, n]`` or DAC's Gumbel matrices ``[L, n, n]``;
  D-PSGD and DEPRL draw nothing; under an adaptive topology policy the
  five draw its participation uniforms ``[L, n]`` and Gumbel noise ``[L,
  n, n]`` instead, FACADE, EL and DAC from the source's topology stream,
  the ring baselines from its counter stream at each round's index;
  under ``net`` the round's netsim
  uniforms and event masks, ``[L, n, n]`` and ``[L, n]``, and under
  ``net.faults`` the crash, restart and corruption uniforms ``[L, n]`` and
  in noise mode the payload noise, ``[L, ...]`` a leaf of the sent tree,
  from the run's ``netsim.NetSchedule``), stacked in pinned memory and
  copied to the card once; before each replay a device-to-device copy
  moves round i's draws into the graph's static inputs. The engine and
  the loop so consume identical draws, and one seed still gives one run
  on every device.
  This is the one deliberate difference from the reference engine;
* **network simulation** (``net``, a ``netsim.NetworkConfig``): the
  captured round runs ``netwire.net_round`` (advance the channel, the
  masks, the node faults and a reset of restarting nodes, the stale
  marks, the round, the gossip fold, the topology policy's EWMAs, the
  round's seconds) as the loop does, with the channel, the gossip buffer,
  the crash chain (its ``down [n]`` and, under ``restart_mode="reset"``,
  the round-0 copy of the state, written once a run) and the policy's
  EWMAs in static buffers of the carry beside the state (the EWMAs ride
  the carry on the ideal medium too, where nothing advances them);
* a segment's outputs leave the card once. Off ``net`` and without an
  adaptive topology policy, ``round_bytes`` is a host float from the
  formula, recorded when the round is captured (it never touches the
  card); under ``net`` or a policy each replay writes its bytes and
  simulated seconds (float32, per round: the delivered or drawn edges
  vary; the seconds 0 off ``net``) into a static pair that is copied
  into row i of an ``[L, 2]`` device buffer after replay i, and FACADE's
  cluster ids likewise into an ``[L, n]`` one. :meth:`SegmentEngine.dispatch_segment` enqueues those
  buffers' copy into pinned host memory behind the last replay and
  records an event after it, and another at the segment's end;
  :meth:`SegmentEngine.drain` waits on the copy's event alone, never on
  the stream or the device. So a pipelined driver (``run_experiment(
  pipeline=True)``) can dispatch segment t+1 and then drain segment t
  while t+1's replays run;
* **telemetry** (``obs``, a ``repro_torch.obs.ObsConfig``): the captured
  round also computes the round's ``MetricsFrame`` (``obs.frame_hook``)
  from the static state tensors, which are still the round's starting
  state, and the new ones, and writes its ``[F]`` row into a static row
  before the carry is overwritten; the row is copied into an ``[L, F]``
  buffer after each replay and rides the segment's one copy to the host.
  The frame only reads, so the round's arithmetic is unchanged, and
  without ``obs`` nothing of it is captured.

**Capture.** The first segment of a warmup flag (and of a train-array
shape) runs ``WARMUP_ROUNDS`` eager rounds on the device's capture stream,
on a scratch clone of the state and round 0's drawn inputs, and throws their
results away: autograd, cuDNN and cuBLAS set up their per-stream state on
a round's first call, not in the capture. Every warm-up and capture on a
device runs on one stream (``_capture_stream``), so cuBLAS keeps one
workspace for all of them. Host syncs are errors during that warm-up
(``torch.cuda.set_sync_debug_mode``), and a round that syncs (``.item()``,
``bool(tensor)``, a copy from pageable host memory) or otherwise cannot be
captured raises, naming the round function. There is no fallback: on CUDA
the engine captures or raises, and never replays eagerly or moves to the
CPU. Both graphs of an engine share one memory pool; nothing allocated in
a capture outlives it.

**Launch counts.** The kernel wrappers count Python calls that launch
(``head_losses.launches``, ...), and a replay makes none. So a capture's
increase of each count is taken back and added again once per replay, and
the counts say what the card ran; warm-up calls are real launches and
count as themselves.

**Node mesh** (``mesh=``, :mod:`.meshctx`): one engine per rank, each
holding its block of ``n / P`` nodes. The state's node-stacked leaves (and
the gossip buffer's and the ``reset`` copy's) and the train arrays keep
the rank's rows; the round's ``[n]`` and ``[n, n]`` tensors (the
channel, the gossip ages, the crash chain, the policy's EWMAs, DAC's
similarity table) stay whole. Every rank draws the whole segment and keeps
its rows of the batch indices and the payload noise. The rounds run
inside ``meshctx.activate``, so the closures gather what the neighbours
send (one ``all_gather_into_tensor`` a round for the sent tree) and take
their rows of the whole mixing matrices (the products at ``mesh=None``'s
shape, ``meshctx.pad_rows``); on CUDA that collective is
captured in the round's graph with the rest (the NCCL communicator is
warmed by one collective first, and every rank captures the same
collective sequence, since every rank runs the same segments). FACADE's
cluster ids ``[L, n/P]`` are gathered into ``[L, n]`` behind the
segment's last round, before its copy to the host, so a drain still
waits on one event.

**On the CPU** there is no graph: the same closures run eagerly, round by
round, from the segment's stacked draws, with the same carry, static
buffers and drain. ``compile_count`` counts captures on CUDA and, on the
CPU, the round programs prepared (one per warmup flag and train-array
shape), so it stays flat on a cell's second run either way.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.data import pipeline
from repro_torch.device import HostCopy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.head_select import head_losses
from repro_torch.kernels.rwkv6 import wkv
from repro_torch.netsim import ChannelState, GossipState, NetDraws
from repro_torch.obs.frame import frame_hook, frame_width, frames_of_rows
from repro_torch.obs.trace import span
from repro_torch.resil import FaultState
from repro_torch.topo import TopoDraw, TopoState, adaptive, static_draw
from repro_torch.tree import tree_map

from . import meshctx, netwire
from .state import EngineCarry

WARMUP_ROUNDS = 1          # eager rounds before a capture
COUNTED = (head_losses, flash_attention, wkv)
# the round's topology draw: FACADE's and EL's permutations, DAC's Gumbel
# matrix, an adaptive policy's TopoDraw from the source's topology stream
# (FACADE, EL, DAC) or from its counter stream at the round (the rings)
TOPOLOGY_DRAWS = ("perms", "gumbel", "policy", "policy_at")
POLICY_DRAWS = ("policy", "policy_at")
# state fields that stay whole on every rank of a node mesh: DAC's
# similarity table [n, n] is a round tensor like the adjacency
WHOLE_FIELDS = ("extra",)


class Segment(NamedTuple):
    start: int           # first round of the span (0-based)
    length: int          # number of rounds in the span
    warmup: bool         # FACADE warmup phase?
    eval_at_end: bool    # the span's last round is an eval round


def segment_plan(rounds: int, eval_every: int,
                 warmup_rounds: int = 0) -> list[Segment]:
    """Cut ``range(rounds)`` into segments.

    Boundaries: every eval round (``(rnd+1) % eval_every == 0`` plus the
    final round — the loop's eval schedule) and the warmup->main phase
    switch (a cut without an eval). Segments never straddle the warmup
    boundary, so each segment replays one round program.
    """
    evals = set(range(eval_every, rounds + 1, eval_every))
    if rounds > 0:
        evals.add(rounds)
    cuts = {0, rounds} | evals
    if 0 < warmup_rounds < rounds:
        cuts.add(warmup_rounds)
    cuts = sorted(cuts)
    return [Segment(a, b - a, a < warmup_rounds, b in evals)
            for a, b in zip(cuts[:-1], cuts[1:])]


def state_tensors(state) -> dict:
    """The state's tensor fields, by name: every field but the round
    counter and those that are ``None``. They are what the engine keeps in
    static buffers and what a checkpoint of the run saves."""
    return {f: v for f, v in zip(state._fields, state)
            if f != "round" and v is not None}


def _name(fn) -> str:
    fn = getattr(fn, "func", fn)            # functools.partial
    return getattr(fn, "__qualname__", repr(fn))


_CAPTURE_STREAMS: dict = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one side stream of ``dev`` that every engine warms up and
    captures on (cuBLAS keeps a workspace per stream it has run on)."""
    if dev.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev.index] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev.index]


@contextlib.contextmanager
def _no_host_sync():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class SegmentEngine:
    """Runs eval-to-eval spans of one algorithm's rounds on one device.

    ``round_fn`` / ``warmup_fn``: the round closures, ``fn(state, batches,
    *topology, net=conds, gossip=published) -> (state, info)`` with
    ``info["round_bytes"]`` a host float off ``net`` (and
    ``info["cluster_id"]`` for FACADE, ``track_cluster``).
    ``topology_draw``: what a round draws besides its batch indices,
    ``"perms"`` (degree ``degree``), ``"gumbel"``, ``"policy"``,
    ``"policy_at"`` (an adaptive ``topo``'s
    :class:`~repro_torch.topo.TopoDraw`, from the source's topology
    stream or its counter stream) or ``None``. ``net``: the run's
    ``netsim.NetworkConfig`` or ``None``; ``mixable_of`` (state -> what
    gossip exchanges) is needed for async gossip. ``topo``: the run's
    ``topo.TopoConfig`` or ``None``; under an adaptive one the round
    closures get its state as ``topo=``. ``obs``: the run's
    ``obs.ObsConfig`` or ``None``; with one, each round's frame row is
    drained as ``frame`` (``mixable_of`` is needed for its norms).
    ``mesh``: ``None``, or a node mesh (a shape ``(P,)`` or anything
    :func:`.meshctx.normalize` takes; :func:`.meshctx.build` makes the
    live ``DeviceMesh`` over the default process group): this rank runs
    its block of ``n / P`` nodes (see the module docstring). ``P`` must
    divide ``n``.

    The engine owns the static buffers its graphs read and write: the
    carry (the state and, under ``net``, the channel and the gossip
    buffer, under an adaptive ``topo`` the policy's EWMAs), the per-round
    inputs and outputs and, on CUDA, the train arrays. A run's carry is
    made by :meth:`init_carry`, which copies the run's initial carry into
    them, so a later run through the same engine overwrites what an
    earlier run left there: whatever outlives a run must be a copy.
    """

    def __init__(self, round_fn: Callable, *, n: int, local_steps: int,
                 batch_size: int, device, warmup_fn: Callable | None = None,
                 track_cluster: bool = False,
                 topology_draw: str | None = None, degree: int = 4,
                 net=None, mixable_of: Callable | None = None, topo=None,
                 obs=None, mesh=None):
        if topology_draw not in (None,) + TOPOLOGY_DRAWS:
            raise ValueError(f"unknown topology draw {topology_draw!r}")
        if adaptive(topo) != (topology_draw in POLICY_DRAWS):
            raise ValueError(f"topology draw {topology_draw!r} does not "
                             f"fit the topology policy {topo!r}")
        self._round = round_fn
        self._warm = warmup_fn if warmup_fn is not None else round_fn
        self._n, self._h, self._b = n, local_steps, batch_size
        self._dev = torch.device(device)
        if self._dev.type == "cuda" and self._dev.index is None:
            self._dev = torch.device("cuda", torch.cuda.current_device())
        self._track = track_cluster
        self._topology_draw = topology_draw
        self._degree = degree
        self._net = net
        self._topo_cfg = topo
        # the round's bytes are a device value: the delivered edges under
        # net, the drawn ones under an adaptive policy
        self._drains = net is not None or adaptive(topo)
        self._mixable_of = mixable_of
        if net is not None and net.async_gossip and mixable_of is None:
            raise ValueError("async_gossip needs mixable_of (state -> the "
                             "tree gossip exchanges); "
                             "runner.algo_program provides it")
        if obs is not None and mixable_of is None:
            raise ValueError("an ObsConfig needs mixable_of (its norms are "
                             "over the mixable state); runner.algo_program "
                             "provides it")
        self._obs = obs
        shape = meshctx.normalize(mesh)
        if shape is not None and n % shape[0]:
            raise ValueError(
                f"mesh of {shape[0]} ranks must divide n={n} nodes evenly: "
                "the carry's node axis is row-sharded in equal blocks (pad "
                "the node count or shrink the mesh)")
        self._mesh = meshctx.build(mesh, self._dev.type)
        self._rows = n if shape is None else n // shape[0]
        self._state = None       # static state tensors, {field: tree}
        self._chan = None        # net: static ChannelState.bad [n, n]
        self._gossip = None      # net: static {"published", "age"}
        self._down = None        # net.faults: static crash chain [n]
        self._init = None        # reset restarts: static round-0 state
        self._topo = None        # adaptive topo: static EWMAs, {field: [n, n]}
        self._scalars = None     # net or adaptive topo: static (bytes,
        #                          seconds) of a round
        self._tiers = None       # obs: static tier vector [n] float32
        self._frame = None       # obs: static frame row [F] of a round
        self._hook = None        # obs: the round's frame hook
        self._inputs = None      # static per-round inputs, {name: tensor}
        self._data = {}          # CUDA: static train arrays per shape/dtype
        self._graphs = {}        # key -> (graph, round_bytes or None,
        #                          launches)
        self._prepared = set()   # CPU: round programs prepared
        self._pool = None
        self.compile_count = 0
        self.capture_s = []      # host seconds of each capture, warm-up in
        self.overlapped = 0      # pipelined segments whose successor was
        #                          still on the card when their host work
        #                          (drain, eval, checkpoint) had ended

    # -- run-level set-up ---------------------------------------------------
    def place_data(self, dataset):
        """``(train_x, train_y)`` of ``dataset`` on the engine's device, as
        ``pipeline.place`` gives them. On CUDA they land in the static
        buffers of their shape and dtype, which the captured rounds read,
        so a later run of the same shapes refills them with no new
        capture. On a node mesh, the rank's rows of them."""
        if self._mesh is None and self._dev.type != "cuda":
            return pipeline.place(dataset, self._dev)
        host = (torch.from_numpy(dataset.train_x),
                torch.from_numpy(dataset.train_y).long())
        if self._mesh is not None:
            host = tuple(meshctx.local_rows(a, self._mesh, self._n)
                         for a in host)
            if self._dev.type != "cuda":
                return tuple(a.to(self._dev) for a in host)
        static = self._static_data(*host)
        for s, h in zip(static, host):
            s.copy_(h)
        return static

    def _static_data(self, train_x, train_y) -> tuple:
        key = _data_key(train_x, train_y)
        if key not in self._data:
            self._data[key] = tuple(
                torch.empty(a.shape, dtype=a.dtype, device=self._dev)
                for a in (train_x, train_y))
        return self._data[key]

    def init_carry(self, state, chan=None, gossip=None, fault=None,
                   topo=None, *, tiers=None) -> EngineCarry:
        """The run's carry: ``state``'s tensors and, under ``net``, the
        channel (bursty presets), the gossip buffer (async gossip) and the
        crash chain (``net.faults`` with a crash rate; under ``reset`` its
        round-0 copy of the state), and under an adaptive topology policy
        its ``TopoState``, copied into the engine's static buffers
        (allocated at the first run); the round counter as given. Under an
        ``ObsConfig``, ``tiers`` (the run's node tiers ``[n]`` float32 on
        the device, ``None``: all core) fills the frame's static tier
        vector. On a node mesh the carry is the whole one, the same on
        every rank, and the engine keeps the rank's rows of it
        (:meth:`_rows_of`)."""
        net = self._net
        faults = None if net is None else net.faults
        chain = faults is not None and faults.crash_rate > 0
        if (fault is None) == chain:
            raise ValueError(f"the engine's network {net!r} "
                             f"{'needs' if chain else 'has no'} "
                             "crash-chain state")
        if chain and (fault.init is None) == (faults.restart_mode
                                              == "reset"):
            raise ValueError("the crash chain's round-0 state copy is "
                             "needed exactly under restart_mode='reset'")
        if (chan is None) != (net is None or net.burst is None):
            raise ValueError(f"the engine's network {net!r} "
                             f"{'needs' if chan is None else 'has no'} "
                             "channel state")
        if (gossip is None) != (net is None or not net.async_gossip):
            raise ValueError(f"the engine's network {net!r} "
                             f"{'needs' if gossip is None else 'has no'} "
                             "async-gossip buffer")
        if (topo is None) == adaptive(self._topo_cfg):
            raise ValueError(f"the engine's topology policy "
                             f"{self._topo_cfg!r} "
                             f"{'needs' if topo is None else 'has no'} "
                             "TopoState")

        def like(l):
            return torch.empty(l.shape, dtype=l.dtype, device=self._dev)

        whole = EngineCarry(state, chan, gossip, fault, topo)
        state, chan, gossip, fault, topo = self._rows_of(whole)
        if self._state is None:
            self._state = tree_map(like, state_tensors(state))
            if chan is not None:
                self._chan = like(chan.bad)
            if gossip is not None:
                self._gossip = tree_map(like, dict(gossip._asdict()))
            if fault is not None:
                self._down = like(fault.down)
                if fault.init is not None:
                    self._init = tree_map(like, state_tensors(fault.init))
            if topo is not None:
                self._topo = tree_map(like, dict(topo._asdict()))
            if self._drains:
                self._scalars = torch.zeros((2,), dtype=torch.float32,
                                            device=self._dev)
            if self._obs is not None:
                self._tiers = torch.zeros((self._n,), dtype=torch.float32,
                                          device=self._dev)
                self._frame = torch.zeros((frame_width(self._obs),),
                                          dtype=torch.float32,
                                          device=self._dev)
                self._hook = frame_hook(
                    self._obs, self._n, self._tiers, self._mixable_of,
                    gather=None if self._mesh is None else functools.partial(
                        meshctx.gather_tree, mesh=self._mesh))
        if self._tiers is not None:
            if tiers is None:
                self._tiers.zero_()
            else:
                self._tiers.copy_(tiers)
        self._load(EngineCarry(state, chan, gossip, fault, topo))
        return self._static_carry(state)

    def _rows_of(self, carry: EngineCarry) -> EngineCarry:
        """The rank's share of a whole carry on a node mesh (the carry
        itself without one): the rows of every node-stacked leaf
        (:func:`.meshctx.node_spec`) of the state, its ``reset`` copy and
        the gossip buffer's published tree; the state's
        :data:`WHOLE_FIELDS`, the gossip ages, the channel, the crash
        chain's ``down`` and the policy's EWMAs whole."""
        if self._mesh is None:
            return carry
        from torch.distributed.tensor import Shard

        def rows(t):
            if isinstance(meshctx.node_spec(t, self._n), Shard):
                return meshctx.local_rows(t, self._mesh, self._n)
            return t

        def state_rows(st):
            return st._replace(**{
                f: v if f in WHOLE_FIELDS else tree_map(rows, v)
                for f, v in state_tensors(st).items()})

        gossip, fault = carry.gossip, carry.fault
        if gossip is not None:
            gossip = gossip._replace(published=tree_map(rows,
                                                        gossip.published))
        if fault is not None and fault.init is not None:
            fault = fault._replace(init=state_rows(fault.init))
        return carry._replace(state=state_rows(carry.state), gossip=gossip,
                              fault=fault)

    @property
    def mesh(self):
        """The live node ``DeviceMesh`` the rounds run on, or ``None``."""
        return self._mesh

    def whole_carry(self, carry: EngineCarry) -> EngineCarry:
        """The inverse of :meth:`_rows_of`: every rank's rows of ``carry``
        gathered whole (one collective, enqueued where the carry stands on
        the stream), the same on every rank; ``carry`` itself without a
        mesh. What a checkpoint saves."""
        if self._mesh is None:
            return carry

        def row_fields(st):
            return {f: v for f, v in state_tensors(st).items()
                    if f not in WHOLE_FIELDS}

        parts = {"state": row_fields(carry.state)}
        if carry.gossip is not None:
            parts["published"] = carry.gossip.published
        if carry.fault is not None and carry.fault.init is not None:
            parts["init"] = row_fields(carry.fault.init)
        got = meshctx.gather_tree(parts, self._mesh)
        gossip, fault = carry.gossip, carry.fault
        if "published" in got:
            gossip = gossip._replace(published=got["published"])
        if "init" in got:
            fault = fault._replace(init=fault.init._replace(**got["init"]))
        return carry._replace(state=carry.state._replace(**got["state"]),
                              gossip=gossip, fault=fault)

    def _static_carry(self, state) -> EngineCarry:
        """A carry whose tensors are the static buffers."""
        fault = None
        if self._down is not None:
            fault = FaultState(self._down, None if self._init is None
                               else state._replace(**self._init))
        return EngineCarry(
            state._replace(**self._state),
            None if self._chan is None else ChannelState(self._chan),
            None if self._gossip is None else GossipState(**self._gossip),
            fault, None if self._topo is None else TopoState(**self._topo))

    def _load(self, carry: EngineCarry):
        """Copy ``carry``'s tensors into the static ones (those that are
        not already them), leaf by key: a round may rebuild a dict in
        another key order."""
        def put(s, l):
            if l is s:
                return
            if l.shape != s.shape or l.dtype != s.dtype:
                raise ValueError(
                    f"carry leaf {tuple(l.shape)} {l.dtype} does not fit "
                    f"the engine's {tuple(s.shape)} {s.dtype}")
            s.copy_(l)

        tree_map(put, self._state, state_tensors(carry.state))
        if self._chan is not None:
            put(self._chan, carry.chan.bad)
        if self._gossip is not None:
            tree_map(put, self._gossip, dict(carry.gossip._asdict()))
        if self._down is not None:
            put(self._down, carry.fault.down)
        if self._init is not None:
            tree_map(put, self._init, state_tensors(carry.fault.init))
        if self._topo is not None:
            tree_map(put, self._topo, dict(carry.topo._asdict()))

    def _store(self, new_state, chan, gossip, fault, topo, info, round_s):
        """End of a round: the new carry's tensors into the static ones,
        leaf by key (the crash chain's ``down``; its round-0 copy is never
        written a round; the policy's EWMAs, which only ``net`` advances),
        under ``net`` or an adaptive policy the round's bytes and seconds
        (0 off ``net``) into the static pair, and under an ``ObsConfig``
        the round's frame row, computed before this overwrote the state it
        read, into the static row."""
        def put(s, l):
            if l is not s:
                s.copy_(l)

        tree_map(put, self._state, state_tensors(new_state))
        if self._net is not None:
            if self._chan is not None:
                put(self._chan, chan.bad)
            if self._gossip is not None:
                tree_map(put, self._gossip, dict(gossip._asdict()))
            if self._down is not None:
                put(self._down, fault.down)
        if self._topo is not None:
            tree_map(put, self._topo, dict(topo._asdict()))
        if self._drains:
            self._scalars[0].copy_(info["round_bytes"])
            if round_s is not None:
                self._scalars[1].copy_(round_s)
        if self._frame is not None:
            self._frame.copy_(info["frame"])

    # -- draws --------------------------------------------------------------
    def _draw_segment(self, source, start: int, length: int, per_node: int,
                      sched=None) -> dict:
        """``length`` rounds of draws from ``source`` (and, under ``net``,
        from its schedule ``sched``), in the loop's per-stream order, each
        stacked ``[length, ...]`` and moved to the device in one copy
        (from pinned memory on CUDA). On a node mesh every rank draws the
        whole rounds and keeps its rows of the batch indices and of the
        payload noise (:meth:`_mine`)."""
        n, idx, topo = self._n, [], []
        nets = {f: [] for f in NetDraws._fields}
        for rnd in range(start, start + length):
            idx.append(self._mine(source.batch_indices(n, self._h, self._b,
                                                       per_node)))
            if self._topology_draw == "perms":
                topo.append(source.perms(n, self._degree))
            elif self._topology_draw == "gumbel":
                topo.append(source.gumbel(n))
            elif self._topology_draw == "policy":
                topo.append(source.policy_draw(n))
            elif self._topology_draw == "policy_at":
                topo.append(static_draw(self._topo_cfg, rnd, n, source))
            if sched is not None:
                for f, v in zip(NetDraws._fields, sched.round(rnd)):
                    if isinstance(v, tuple):        # the payload noise
                        for i, leaf in enumerate(v):
                            nets.setdefault(f"{f}.{i}", []).append(
                                self._mine(leaf))
                    elif v is not None:
                        nets[f].append(v)
        out = {"idx": self._stack(idx)}
        if topo and self._topology_draw in POLICY_DRAWS:
            for f in TopoDraw._fields:
                out["policy." + f] = self._stack([getattr(d, f)
                                                  for d in topo])
        elif topo:
            out[self._topology_draw] = self._stack(topo)
        for f, parts in nets.items():
            if parts:
                out["net." + f] = self._stack(parts)
        return out

    def _mine(self, t):
        """The rank's rows of a whole node-leading draw on a node mesh."""
        if self._mesh is None:
            return t
        return meshctx.local_rows(t, self._mesh, self._n)

    def _stack(self, parts) -> torch.Tensor:
        pin = self._dev.type == "cuda"
        block = torch.empty((len(parts),) + tuple(parts[0].shape),
                            dtype=parts[0].dtype, pin_memory=pin)
        torch.stack([p.cpu() for p in parts], out=block)
        return block.to(self._dev, non_blocking=pin)

    def _set_inputs(self, draws: dict, i: int):
        if self._inputs is None:
            self._inputs = {k: torch.empty_like(v[0])
                            for k, v in draws.items()}
        for k, v in draws.items():
            self._inputs[k].copy_(v[i])

    def _topology_args(self, inputs: dict) -> tuple:
        if self._topology_draw in POLICY_DRAWS:
            return (TopoDraw(*(inputs["policy." + f]
                               for f in TopoDraw._fields)),)
        return tuple(inputs[k] for k in TOPOLOGY_DRAWS if k in inputs)

    def _step(self, fn, carry: EngineCarry, inputs: dict, train_x,
              train_y) -> tuple:
        """One round of ``fn`` from ``carry`` on ``inputs`` (one round's
        draws, on the device): ``(state, chan, gossip, fault, topo, info,
        round_s)``, under ``net`` through ``netwire.net_round``, the loop's
        path; under an ``ObsConfig`` ``info["frame"]`` holds the round's
        frame row, from the carry's state before the round (the static
        buffers, which only :meth:`_store` overwrites). On a node mesh
        the round runs inside ``meshctx.activate``."""
        with meshctx.activate(self._mesh):
            return self._step_on(fn, carry, inputs, train_x, train_y)

    def _step_on(self, fn, carry: EngineCarry, inputs: dict, train_x,
                 train_y) -> tuple:
        batches = pipeline.sample_round_batches(inputs["idx"], train_x,
                                                train_y)
        drawn = self._topology_args(inputs)
        if self._net is None:
            state, info = fn(carry.state, batches, *drawn,
                             **netwire.topo_kw(carry.topo))
            if self._hook is not None:
                info["frame"] = self._hook(carry.state, state, info, None,
                                           None)
            return state, None, None, None, carry.topo, info, None
        fields = {f: inputs.get("net." + f) for f in NetDraws._fields}
        noise = []             # the payload noise, one input a leaf
        while f"net.noise.{len(noise)}" in inputs:
            noise.append(inputs[f"net.noise.{len(noise)}"])
        fields["noise"] = tuple(noise) if noise else None
        return netwire.net_round(fn, self._mixable_of, carry.state,
                                 carry.chan, carry.gossip, carry.fault,
                                 batches, drawn, self._net,
                                 NetDraws(**fields), self._h,
                                 topo_cfg=self._topo_cfg, topo=carry.topo,
                                 frame=self._hook)

    # -- one segment --------------------------------------------------------
    def dispatch_segment(self, carry: EngineCarry, start: int, length: int,
                         train_x, train_y, source, warmup: bool = False,
                         net=None, tracer=None):
        """Draw ``length`` rounds from ``source`` (under ``net``, the run's
        ``netsim.NetSchedule``, also its network draws) and run them from
        ``carry``; returns ``(new_carry, outs)`` with the per-round outs
        still in flight (pair with :meth:`drain`): FACADE's cluster ids
        and, under ``net``, each round's bytes and seconds as one
        :class:`~repro_torch.device.HostCopy` enqueued behind the
        segment's last round (``outs["copy"]``), and ``outs["end"]``, on
        CUDA an event recorded at the segment's end (``None`` on the CPU).
        ``start`` is the segment's first round, 0-based; the state's round
        counter follows it. On CUDA, apart from a round's first capture
        (which synchronises the device), nothing here waits for the
        card. ``tracer`` (an ``obs.Tracer``) wraps the call in a
        ``compile`` span where the segment's round is captured (on the
        CPU: prepared) first, else in a ``dispatch`` span."""
        if carry.state.round != start:
            raise ValueError(f"carry is at round {carry.state.round}, the "
                             f"segment starts at {start}")
        if (net is None) != (self._net is None) or (
                net is not None and net.cfg != self._net):
            raise ValueError(f"the engine runs network {self._net!r}; "
                             f"dispatch_segment got the schedule of "
                             f"{None if net is None else net.cfg!r}")
        key = (warmup,) + _data_key(train_x, train_y)
        fresh = key not in (self._graphs if self._dev.type == "cuda"
                            else self._prepared)
        with span(tracer, "compile" if fresh else "dispatch",
                  length=length, warmup=warmup):
            draws = self._draw_segment(source, start, length,
                                       train_x.shape[1], net)
            self._load(carry)
            carry = self._static_carry(carry.state)
            fn = self._warm if warmup else self._round
            if self._dev.type == "cuda":
                outs = self._replay(key, fn, draws, length, train_x,
                                    train_y, carry)
            else:
                outs = self._eager(key, fn, draws, length, train_x,
                                   train_y, carry)
        device_outs = outs.pop("device")
        if self._mesh is not None and "cluster_id" in device_outs:
            device_outs["cluster_id"] = self._gather_ids(
                device_outs["cluster_id"])
        outs["copy"] = HostCopy(device_outs) if device_outs else None
        outs["end"] = None
        if self._dev.type == "cuda":
            outs["end"] = torch.cuda.Event()
            outs["end"].record(torch.cuda.current_stream(self._dev))
        return carry._replace(
            state=carry.state._replace(round=start + length)), outs

    def _gather_ids(self, ids):
        """A segment's cluster ids ``[L, n/P]`` from every rank -> ``[L,
        n]``, enqueued behind the segment's last round."""
        got = meshctx.gather_rows(ids.t(), self._mesh)         # [n, L]
        return got.t().contiguous()

    def drain(self, outs, tracer=None, length: int | None = None) -> dict:
        """A dispatched segment's outs on the host: ``round_bytes`` ``[L]``
        float64, under ``net`` (or an adaptive policy, where they are 0)
        ``round_s`` ``[L]`` float64 (the float32 values each round
        computed), for FACADE ``cluster_id`` ``[L, n]`` and under an
        ``ObsConfig`` ``frame``, the rounds' ``obs.MetricsFrame`` (numpy,
        leading axis L), waiting on the event behind their copy and on
        nothing enqueued after it. ``tracer`` wraps the wait in a
        ``drain`` span."""
        with span(tracer, "drain",
                  **({} if length is None else {"length": length})):
            host = {"round_bytes": outs["round_bytes"]}
            if outs["copy"] is not None:
                got = outs["copy"].wait()
                if "cluster_id" in got:
                    host["cluster_id"] = got["cluster_id"]
                if "scalars" in got:
                    pair = got["scalars"].numpy().astype(np.float64)
                    host["round_bytes"], host["round_s"] = (pair[:, 0],
                                                            pair[:, 1])
                if "frame" in got:
                    host["frame"] = frames_of_rows(got["frame"].numpy(),
                                                   self._obs)
        return host

    def run_segment(self, carry: EngineCarry, start: int, length: int,
                    train_x, train_y, source, warmup: bool = False,
                    net=None, tracer=None):
        """:meth:`dispatch_segment`, then :meth:`drain`."""
        carry, outs = self.dispatch_segment(carry, start, length, train_x,
                                            train_y, source, warmup=warmup,
                                            net=net, tracer=tracer)
        return carry, self.drain(outs, tracer=tracer, length=length)

    def _out_buffers(self, length: int) -> dict:
        """The segment's device outputs, filled row by row after each
        round: FACADE's cluster ids ``[L, n]``, under ``net`` or an
        adaptive policy the rounds' (bytes, seconds) ``[L, 2]``, and under
        an ``ObsConfig`` their frame rows ``[L, F]``."""
        out = {}
        if self._track:
            out["cluster_id"] = torch.empty((length, self._rows),
                                            dtype=torch.long,
                                            device=self._dev)
        if self._drains:
            out["scalars"] = torch.empty((length, 2), dtype=torch.float32,
                                         device=self._dev)
        if self._frame is not None:
            out["frame"] = torch.empty((length, self._frame.shape[0]),
                                       dtype=torch.float32, device=self._dev)
        return out

    def _fill_row(self, bufs: dict, i: int):
        if "cluster_id" in bufs:
            bufs["cluster_id"][i].copy_(self._state["cluster_id"])
        if "scalars" in bufs:
            bufs["scalars"][i].copy_(self._scalars)
        if "frame" in bufs:
            bufs["frame"][i].copy_(self._frame)

    def _eager(self, key, fn, draws, length, train_x, train_y, carry):
        if key not in self._prepared:
            self._prepared.add(key)
            self.compile_count += 1
        rb = np.empty(length, np.float64)
        bufs = self._out_buffers(length)
        for i in range(length):
            inputs = {k: v[i] for k, v in draws.items()}
            state, chan, gossip, fault, topo, info, round_s = self._step(
                fn, carry, inputs, train_x, train_y)
            self._store(state, chan, gossip, fault, topo, info, round_s)
            carry = carry._replace(
                state=carry.state._replace(round=carry.state.round + 1))
            if not self._drains:
                rb[i] = info["round_bytes"]
            self._fill_row(bufs, i)
        return {"round_bytes": None if self._drains else rb,
                "device": bufs}

    def _replay(self, key, fn, draws, length, train_x, train_y, carry):
        train_x, train_y = self._bind_data(train_x, train_y)
        if key not in self._graphs:
            self._set_inputs(draws, 0)
            self._graphs[key] = self._capture(fn, train_x, train_y, carry)
            self.compile_count += 1
        graph, round_bytes, launches = self._graphs[key]
        bufs = self._out_buffers(length)
        for i in range(length):
            self._set_inputs(draws, i)
            graph.replay()
            for kernel, count in launches:
                kernel.launches += count
            self._fill_row(bufs, i)
        return {"round_bytes": None if round_bytes is None
                else np.full(length, round_bytes, np.float64),
                "device": bufs}

    def _bind_data(self, train_x, train_y) -> tuple:
        """The static train arrays of these shapes, refilled from the
        given ones unless they are those arrays (``place_data``)."""
        static = self._static_data(train_x, train_y)
        for s, a in zip(static, (train_x, train_y)):
            if a is not s:
                s.copy_(a)
        return static

    def _capture(self, fn, train_x, train_y, carry) -> tuple:
        """Warm ``fn`` up on a scratch clone of ``carry`` (the static
        tensors), then capture one round of it into a graph that reads the
        static inputs and carry and ends by writing the new carry (and,
        under ``net`` or an adaptive policy, the round's bytes and seconds)
        over the old. Returns ``(graph, round_bytes or None where they are
        drained, [(kernel, launches a replay)])``."""
        t0 = time.perf_counter()
        inputs, name = self._inputs, _name(fn)

        def one_round(c):
            return self._step(fn, c, inputs, train_x, train_y)

        scratch = EngineCarry(
            carry.state._replace(**tree_map(torch.clone, self._state)),
            None if carry.chan is None else ChannelState(
                carry.chan.bad.clone()),
            None if carry.gossip is None else GossipState(
                **tree_map(torch.clone, dict(carry.gossip._asdict()))),
            None if carry.fault is None else carry.fault._replace(
                down=carry.fault.down.clone()),
            None if carry.topo is None else TopoState(
                *(t.clone() for t in carry.topo)))
        side = _capture_stream(self._dev)
        if self._mesh is not None:
            # NCCL sets up its communicator at its first collective, which
            # must not be in a capture or in the sync-checked warm-up
            meshctx.gather_rows(torch.zeros((1,), device=self._dev),
                                self._mesh)
            torch.cuda.synchronize(self._dev)
        side.wait_stream(torch.cuda.current_stream(self._dev))
        try:
            with torch.cuda.stream(side), _no_host_sync():
                for _ in range(WARMUP_ROUNDS):
                    one_round(scratch)
        except RuntimeError as e:
            raise RuntimeError(
                f"round function {name} failed in its warm-up before "
                f"capture, where a host sync (.item(), bool(tensor), a copy "
                f"from pageable memory) is an error: {e}") from e
        torch.cuda.current_stream(self._dev).wait_stream(side)
        del scratch

        def captured_round():
            new, chan, gossip, fault, topo, info, round_s = one_round(carry)
            self._store(new, chan, gossip, fault, topo, info, round_s)
            if self._drains:
                return None
            rb = info["round_bytes"]
            if not isinstance(rb, (int, float)):
                raise TypeError(f"round function {name} returned "
                                f"round_bytes {type(rb).__name__}, not a "
                                f"host number")
            return float(rb)

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = [k.launches for k in COUNTED]
        # on a node mesh, NCCL's watchdog thread polls events while this
        # thread captures: only this thread's capture is checked
        mode = "global" if self._mesh is None else "thread_local"
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode=mode):
                round_bytes = captured_round()
        except RuntimeError as e:
            raise RuntimeError(f"capturing round function {name} in a CUDA "
                               f"graph failed: {e}") from e
        finally:
            # the capture launched nothing: take its counts back
            made = [k.launches - b for k, b in zip(COUNTED, before)]
            for k, b in zip(COUNTED, before):
                k.launches = b
        self.capture_s.append(time.perf_counter() - t0)
        return graph, round_bytes, [(k, m) for k, m in zip(COUNTED, made)
                                    if m]


def _data_key(train_x, train_y) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype)) for a in (train_x, train_y))
