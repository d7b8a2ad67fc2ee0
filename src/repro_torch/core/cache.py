"""Cross-run cache: the seed-independent machinery behind a sweep cell.

The counterpart of ``repro.core.cache``. ``run_experiment`` builds, for
every call, the model binding, the algorithm's round closures, the segment
engine (whose rounds are captured as CUDA graphs at their first segment)
and the evaluator. A sweep of S seeds over one configuration would pay S
identical captures. :class:`EngineCache` memoizes on a static
:class:`EngineSpec` key:

* the :class:`~repro_torch.core.bindings.Binding` and the algorithm
  *program* (round closures, ``models_of``, ``finalize``: everything
  ``runner.algo_program`` builds; the initial state is the per-run piece,
  minted from the run's draws source);
* one :class:`~repro_torch.core.engine.SegmentEngine` per entry, whose
  captured rounds (one per warmup flag and train-array shape) and static
  buffers every run of the cell shares;
* evaluators, cache-wide on ``(model cfg, eval batch, content fingerprint
  of the eval split, device)``, whatever the algorithm.

Cache-key contract: every knob that changes a captured round or the
round and eval arithmetic is a field of :class:`EngineSpec` (the
device-side telemetry frame, ``obs``, among them; the host-side settings
of an ``obs.Obs`` never are); only the seed
(the draws) and the data vary within an entry. The device is a field: a
graph captured on one device cannot serve another. ``rounds`` and
``eval_every`` are not: the engine captures one round, whatever the
segments' lengths. A changed eval split changes the fingerprint and never
reuses a stale evaluator; train data is passed per run.

Static buffers: an entry's engine owns the state, inputs and train arrays
its graphs read and write. Each run copies its own initial state in, and
``run_experiment`` returns copies, so a later run of the entry leaves an
earlier run's result as it was. ``run_experiment`` pins its entry for the
run: an LRU-bounded cache (``max_entries``) never evicts an entry in use,
and overshoots the bound rather than break a run.

Not ported: the reference's ``persist_dir`` (``attach_persist_dir`` /
``detach_persist_dir``), which points JAX's on-disk compile cache at a
directory. A CUDA graph cannot be serialised, and the kernels' build
directory (``build/kernels``) already persists across processes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import weakref
from typing import Any

import numpy as np
import torch

from . import meshctx
from .bindings import make_binding
from .engine import SegmentEngine


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Static cache key for one sweep cell. Two specs compare equal iff
    every captured round and every closure they imply is interchangeable.
    ``cfg`` is a frozen model config."""
    algo: str                    # facade | el | dpsgd | deprl | dac
    cfg: Any                     # CNNConfig (frozen)
    n: int                       # number of nodes
    k: int                       # number of clusters / FACADE heads
    degree: int
    local_steps: int
    batch_size: int
    lr: float
    warmup_rounds: int = 0
    head_jitter: float = 0.0
    eval_batch: int = 256        # make_evaluator batch size
    device: torch.device = torch.device("cuda")
    net: Any = None              # netsim.NetworkConfig | None (frozen): the
    #                              captured round runs its masks, channel,
    #                              gossip buffer and node faults (every
    #                              field of net.faults forks the key)
    topo: Any = None             # topo.TopoConfig | None (frozen): the
    #                              adaptive policy the captured round
    #                              samples with (every field forks the key)
    obs: Any = None              # obs.ObsConfig | None (frozen): the
    #                              device-side telemetry frame the captured
    #                              round computes and writes (every field
    #                              forks the key); the host settings on
    #                              obs.Obs (sink, health, out_dir,
    #                              profile_dir) never appear here
    mesh: Any = None             # node-mesh SHAPE (P,) or None
    #                              (meshctx.normalize's form, never a
    #                              DeviceMesh): a sharded round holds
    #                              other shapes and collectives, so
    #                              sharded and unsharded runs never share
    #                              an entry


_FP_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def data_fingerprint(dataset) -> str:
    """Content hash of everything an evaluator closes over: the node ->
    cluster map and the per-cluster eval split (shapes, dtypes, bytes),
    the reference's hash of the same arrays.

    Memoized per dataset object (weakly, so the memo never pins data).
    Mutating a dataset's eval arrays in place after first use is not
    detected: build a new dataset instead (the synthetic pipeline always
    does).
    """
    try:
        return _FP_MEMO[dataset]
    except (KeyError, TypeError):   # TypeError: non-weakrefable dataset
        pass
    h = hashlib.sha1()

    def feed(a):
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())

    feed(dataset.node_cluster)
    for x, y in zip(dataset.test_x, dataset.test_y):
        feed(x)
        feed(y)
    fp = h.hexdigest()
    try:
        _FP_MEMO[dataset] = fp
    except TypeError:
        pass
    return fp


class CacheEntry:
    """Seed-independent machinery for one :class:`EngineSpec`: binding,
    algorithm program and segment engine. ``setup(draws)`` mints a run's
    :class:`~repro_torch.core.runner.AlgoSetup` over the shared closures;
    the initial state is the only per-run piece."""

    def __init__(self, spec: EngineSpec):
        from . import runner     # runner imports this module; bind lazily
        self.spec = spec
        self.binding = make_binding(spec.cfg)
        self.program = runner.algo_program(
            spec.algo, self.binding, spec.n, spec.k, degree=spec.degree,
            lr=spec.lr, head_jitter=spec.head_jitter,
            faults=None if spec.net is None else spec.net.faults,
            topo=spec.topo)
        self.engine = SegmentEngine(
            self.program.round_fn, warmup_fn=self.program.warmup_fn,
            n=spec.n, local_steps=spec.local_steps,
            batch_size=spec.batch_size, device=spec.device,
            track_cluster=self.program.track_cluster,
            topology_draw=self.program.topology_draw, degree=spec.degree,
            net=spec.net, mixable_of=self.program.mixable_of,
            topo=spec.topo, obs=spec.obs, mesh=spec.mesh)

    def setup(self, draws):
        return self.program.setup(draws, self.spec.device)

    @property
    def compile_count(self) -> int:
        return self.engine.compile_count


class EngineCache:
    """Config-keyed store of :class:`CacheEntry` and evaluators.

    ``entry(spec)`` returns the cell's entry, building it on first use;
    ``evaluator(binding, dataset, batch, device, mesh)`` the (cfg, batch,
    fingerprint, device, mesh)-keyed evaluator, on the card unless
    ``device`` says otherwise, as ``runner.make_evaluator`` (``mesh``: a
    live node mesh, whose rank evaluates its block of nodes). ``compile_count``
    totals every program the cache ever built (captured rounds plus
    evaluator builds, monotone across LRU evictions), which stays flat
    once a cell is warm.
    ``max_entries``: LRU bound on live entries; ``None`` keeps every
    entry.
    """

    def __init__(self, *, max_entries: int | None = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError(
                f"max_entries={max_entries} must be >= 1 (or None for "
                "an unbounded cache): a run always needs its own entry")
        self._entries: dict[EngineSpec, CacheEntry] = {}  # insertion = LRU
        self._evaluators: dict[tuple, Any] = {}
        self._pins: dict[EngineSpec, int] = {}
        self.hits = 0            # entry() served from cache
        self.misses = 0          # entry() had to build
        self.evictions = 0       # entries dropped by the LRU bound
        self.evaluator_builds = 0
        self.max_entries = max_entries
        self._evicted_compiles = 0   # keeps compile_count monotone

    def entry(self, spec: EngineSpec, tracer=None) -> CacheEntry:
        """``spec``'s entry, built on first use; ``tracer`` (an
        ``obs.Tracer``) records a ``cache.evict`` event for every entry the
        LRU bound drops."""
        e = self._entries.get(spec)
        if e is None:
            self.misses += 1
            e = self._entries[spec] = CacheEntry(spec)
        else:
            self.hits += 1
            self._entries[spec] = self._entries.pop(spec)  # -> MRU slot
        self._evict(keep=spec, tracer=tracer)
        return e

    def _evict(self, keep: EngineSpec, tracer=None):
        if self.max_entries is None:
            return
        while len(self._entries) > self.max_entries:
            victim = next(
                (s for s in self._entries       # oldest first = LRU order
                 if s != keep and self._pins.get(s, 0) == 0), None)
            if victim is None:
                return   # every live entry is pinned by a running
                #          experiment: overshoot rather than break one
            dead = self._entries.pop(victim)
            self._evicted_compiles += dead.compile_count
            self.evictions += 1
            if tracer is not None:
                tracer.event("cache.evict", algo=victim.algo,
                             entries=len(self._entries))

    @contextlib.contextmanager
    def pin(self, spec: EngineSpec):
        """Hold ``spec``'s entry out of LRU eviction for the duration;
        ``run_experiment`` wraps each run in this."""
        self._pins[spec] = self._pins.get(spec, 0) + 1
        try:
            yield
        finally:
            n = self._pins[spec] - 1
            if n:
                self._pins[spec] = n
            else:
                del self._pins[spec]

    def pinned(self, spec: EngineSpec) -> bool:
        return self._pins.get(spec, 0) > 0

    def evaluator(self, binding, dataset, batch: int = 256,
                  device="cuda", mesh=None):
        device = torch.device(device)
        key = (binding.cfg, batch, data_fingerprint(dataset), device)
        if mesh is not None:
            key += (meshctx.normalize(mesh),)
        ev = self._evaluators.get(key)
        if ev is None:
            from . import runner
            ev = self._evaluators[key] = runner.make_evaluator(
                binding, dataset.node_cluster, dataset.test_x,
                dataset.test_y, batch=batch, device=device, mesh=mesh)
            self.evaluator_builds += 1
        return ev

    @property
    def compile_count(self) -> int:
        return (sum(e.compile_count for e in self._entries.values())
                + self._evicted_compiles + self.evaluator_builds)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "compiles": self.compile_count,
                "evaluator_builds": self.evaluator_builds,
                "max_entries": self.max_entries}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, spec) -> bool:
        return spec in self._entries
