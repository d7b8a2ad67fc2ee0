"""Experiment runner: drives FACADE or a baseline (EL, D-PSGD, DEPRL,
DAC) over a clustered dataset, evaluating per-cluster accuracy, fairness
metrics and communication volume — the harness behind the paper's
tables, on one device — and FACADE rounds on a language model
(:class:`LMFacade`).

The counterpart of ``repro.core.runner``. Two drivers share the set-up
and the evaluation: ``engine=True`` (the default), the segment engine
(:mod:`.engine`: on CUDA one captured round replayed per round of an
eval-to-eval span, one host transfer a span), and ``engine=False``, the
per-round loop, the engine's parity reference. On one device both give
the same run bit for bit. The engine runs its segments one after the
other, or pipelined (``pipeline=True``: segment t+1 dispatched before
segment t is drained), and checkpoints and resumes a run at segment
boundaries (``ckpt=``). The seed-independent machinery (binding, round
closures, engine, evaluator) comes from an :class:`~.cache.EngineCache`
(``cache=``; a private one by default). Both drivers run the five
algorithms under simulated network conditions (``net=``, a
``netsim.NetworkConfig``) and node faults (``net.faults``, a
``resil.FaultConfig``: crashes and restarts, payload corruption, the
robust guard): each round's masks, the bursty channel, the async-gossip
buffer and the crash chain are threaded through the loop, and carried in
the engine's static buffers. Both also run the five under an adaptive
topology policy (``topo=``, a ``topo.TopoConfig``), with or without
``net``: its per-link EWMAs are threaded and carried the same way. Both
record run telemetry under ``obs=`` (a ``repro_torch.obs.Obs``): a
per-round ``MetricsFrame`` computed on the device at the same point of
the round (inside the captured graph on the engine, drained with the
segment's other outputs), tracer spans around capture, dispatch, drain,
eval and checkpoint, a health verdict and a run manifest at the end. The
engine also runs on a node mesh (``mesh=``, :mod:`.meshctx`): one process
per card, every rank calling ``run_experiment`` with the same arguments
and holding its block of ``n / P`` nodes, gossip a row-block contraction
over all-gathered senders; every rank returns the same ``RunResult``.

Randomness comes from a *draws* source (:class:`TorchDraws` by default):
it supplies the initial parameters, each round's ``[n, H, B]`` batch
indices and each round's topology draw (FACADE and EL: the permutations
of a random regular graph; DAC: a Gumbel matrix; D-PSGD and DEPRL, on a
static ring: none; under an adaptive ``topo`` each of the five draws the
policy's participation uniforms and Gumbel noise instead, a
``topo.TopoDraw``: FACADE, EL and DAC from the topology stream
(``policy_draw``), D-PSGD and DEPRL counter-based at the round's index
(``policy_draw_at``)) and, under ``net``, the uniforms of the network
simulation and its node faults (``net_uniform``/``net_randint``/
``net_normal``, counter-based: a draw depends only on the network's seed,
its stream, its round and, for payload noise, the leaf), so a run
can replay another's draws exactly. ``TorchDraws`` draws on the CPU and
the runner moves the draws to the run's device, so one seed gives the
same draws on every device. The run's
randomness lives in the draws source and not in the engine's carry, so a
checkpoint holds the source's state (``state()`` / ``set_state``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch import device as device_mod
from repro_torch import netsim, resil
from repro_torch import topo as topo_mod
from repro_torch.comm import CommLog
from repro_torch.data import pipeline as pipeline_mod
from repro_torch.data.tokens import TokenSpec, make_clustered_tokens
from repro_torch.device import HostCopy
from repro_torch.obs import (EvalFrame, HealthContext, MetricsFrame,
                             RunManifest, compute_eval_frame,
                             evaluate_health, fingerprint, frame_hook,
                             frames_of_rows, tiers_of)
from repro_torch.obs.trace import span
from repro_torch.tree import tree_map

from . import facade as facade_mod
from . import meshctx, netwire, split, topology
from .baselines import (DACConfig, DeprlConfig, DpsgdConfig, ELConfig,
                        dac_round, deprl_round, dpsgd_round, el_round,
                        init_dac_extra)
from .bindings import Binding, make_binding
from .cache import EngineCache, EngineSpec
from .engine import SegmentEngine, segment_plan, state_tensors
from .state import EngineCarry, init_baseline_state, init_facade_state

# baseline -> (config, round function, the round's topology draw)
BASELINES = {"el": (ELConfig, el_round, "perms"),
             "dpsgd": (DpsgdConfig, dpsgd_round, None),
             "deprl": (DeprlConfig, deprl_round, None),
             "dac": (DACConfig, dac_round, "gumbel")}
ALGOS = ("facade",) + tuple(BASELINES)


@dataclasses.dataclass
class RunResult:
    algo: str
    acc_per_cluster: list      # history: [(round, [acc_c0, acc_c1, ...])]
    fair_acc: list             # [(round, fair_acc)]
    dp: float                  # final demographic parity
    eo: float                  # final equalized odds
    comm: CommLog
    cluster_history: list      # FACADE: [(round, cluster_id int32 array)]
    final_acc: list            # per-cluster accuracy at the end
    node_acc: Any = None       # final per-node accuracy [n]
    eval_frames: list = dataclasses.field(default_factory=list)
    models: Any = None         # final deployable models, node-stacked
    #                            [n, ...] on the run's device

    def best_fair_acc(self) -> float:
        return max(v for _, v in self.fair_acc) if self.fair_acc else 0.0


# --------------------------------------------------------------------------
class TorchDraws:
    """The port's own draws, from CPU ``torch.Generator``s seeded with
    ``seed``: one stream for the initial parameters, one for batch
    indices and one for topologies (permutations, Gumbel draws or an
    adaptive policy's draws). The network simulation's uniforms and the
    ring baselines' policy draws come from
    :class:`~repro_torch.topo.CounterDraws`, a generator per ``(seed,
    stream, index)``, which holds no state."""

    _net = topo_mod.CounterDraws()

    def __init__(self, seed: int):
        streams = np.random.SeedSequence(seed).generate_state(3)
        self._init, self._data, self._topo = (
            torch.Generator().manual_seed(int(s)) for s in streams)

    def facade_init(self, binding: Binding, k: int, head_jitter: float):
        """(one model's params, its ``[k, ...]`` head bank)."""
        params = binding.init(self._init)
        _, head = split.split_params(params, binding.head_keys)
        return params, split.stack_heads(head, k, generator=self._init,
                                         jitter=head_jitter)

    def baseline_init(self, binding: Binding):
        return binding.init(self._init)

    def batch_indices(self, n: int, h: int, b: int, per_node: int):
        return pipeline_mod.draw_batch_indices(self._data, n, h, b, per_node)

    def perms(self, n: int, r: int):
        return topology.draw_perms(self._topo, n, r)

    def gumbel(self, n: int):
        """``[n, n]`` standard Gumbel draws, ``-log(-log(U))`` with U
        uniform in [tiny, 1)."""
        return topo_mod.gumbel_of(torch.rand((n, n), generator=self._topo))

    def policy_draw(self, n: int) -> "topo_mod.TopoDraw":
        """An adaptive topology policy's round draw from the topology
        stream: the participation uniforms ``[n]``, then the Gumbel noise
        ``[n, n]`` (as :meth:`gumbel`)."""
        u = torch.rand((n,), generator=self._topo)
        return topo_mod.TopoDraw(u, self.gumbel(n))

    def policy_draw_at(self, seed: int, tag, rnd: int,
                       n: int) -> "topo_mod.TopoDraw":
        """The policy's round draw for the ring baselines, counter-based
        on ``(seed, tag, rnd)`` (``topo.counter_draw``)."""
        return self._net.policy_draw_at(seed, tag, rnd, n)

    def net_uniform(self, seed: int, tag: int, index: int, shape):
        return self._net.net_uniform(seed, tag, index, shape)

    def net_randint(self, seed: int, tag: int, index: int, shape,
                    high: int):
        return self._net.net_randint(seed, tag, index, shape, high)

    def net_normal(self, seed: int, tag: int, index: int, leaf: int,
                   shape):
        return self._net.net_normal(seed, tag, index, leaf, shape)

    def state(self) -> dict:
        """The three generators' states: what a checkpoint must hold for a
        resumed run to draw what the uninterrupted run draws."""
        return {"init": self._init.get_state(),
                "data": self._data.get_state(),
                "topo": self._topo.get_state()}

    def set_state(self, state: dict):
        """Restore :meth:`state`'s generator states."""
        for gen, name in ((self._init, "init"), (self._data, "data"),
                          (self._topo, "topo")):
            gen.set_state(state[name])


# --------------------------------------------------------------------------
class AlgoProgram(NamedTuple):
    """The seed-independent part of an algorithm, behind one round
    signature: ``round_fn(state, batches, *topology, net=conds,
    gossip=published[, topo=tstate]) -> (state, info)``, where ``topology``
    is the round's ``topology_draw`` (FACADE and EL: ``perms``, DAC:
    ``gumbel``, D-PSGD and DEPRL: none; under an adaptive topology policy
    one ``topo.TopoDraw``, ``policy`` for FACADE, EL and DAC, ``policy_at``
    for the rings) and ``tstate`` the policy's ``TopoState``, passed only
    under an adaptive policy. ``EngineCache`` memoizes programs per static
    configuration and mints each run's :class:`AlgoSetup` with
    :meth:`setup`."""
    init_state: Callable       # (draws, device) -> initial stacked state
    round_fn: Callable         # main-phase round
    warmup_fn: Callable        # warmup-phase round (== round_fn off-FACADE)
    models_of: Callable        # state -> deployable models, stacked [n, ...]
    finalize: Callable         # applied to the state after the last round
    track_cluster: bool        # info carries a per-round cluster_id [n]
    topology_draw: str | None  # "perms" | "gumbel" | "policy" |
    #                            "policy_at" | None
    mixable_of: Callable       # state -> what gossip exchanges (the async
    #                            staleness buffer snapshots this tree)
    sent_of: Callable          # state -> what a node sends, the tree
    #                            payload corruption mangles
    sent_lead: Any             # stacked axes in front of each model leaf
    #                            of ``sent_of``: an int or a dict by key

    def setup(self, draws, device) -> "AlgoSetup":
        return AlgoSetup(self, self.init_state(draws, device))


class AlgoSetup(NamedTuple):
    """One run: its algorithm's program and the initial stacked state,
    minted from the run's draws."""
    program: AlgoProgram
    state: Any


def algo_program(algo: str, binding: Binding, n: int, k: int, *,
                 degree: int, lr: float, head_jitter: float = 0.0,
                 faults=None, topo=None) -> AlgoProgram:
    """The program of ``algo`` (one of :data:`ALGOS`) on ``binding``'s
    model, ``n`` nodes, ``k`` FACADE heads. ``faults``: the run's frozen
    ``resil.FaultConfig`` (``net.faults``) or ``None``, closed over the
    round closures (payload corruption and the robust guard). ``topo``:
    the run's frozen ``topo.TopoConfig`` or ``None``, closed over them
    too; an adaptive one replaces the algorithm's topology draw with the
    policy's."""
    adaptive = topo_mod.adaptive(topo)
    if algo == "facade":
        fcfg = facade_mod.FacadeConfig(n_nodes=n, k=k, degree=degree, lr=lr)

        def init_state(draws, device):
            params, heads_k = draws.facade_init(binding, k, head_jitter)
            return init_facade_state(binding, n, k, params=params,
                                     heads_k=heads_k, device=device)

        return AlgoProgram(
            init_state=init_state,
            round_fn=functools.partial(facade_mod.facade_round, fcfg,
                                       binding, warmup=False,
                                       topo_cfg=topo, fault_cfg=faults),
            warmup_fn=functools.partial(facade_mod.facade_round, fcfg,
                                        binding, warmup=True,
                                        topo_cfg=topo, fault_cfg=faults),
            models_of=facade_mod.node_models,
            finalize=functools.partial(facade_mod.final_allreduce, fcfg),
            track_cluster=True,
            topology_draw="policy" if adaptive else "perms",
            mixable_of=_facade_sent, sent_of=_facade_sent,
            sent_lead={"cores": 1, "heads": 2})
    if algo in BASELINES:
        cfg_cls, round_fn, topology_draw = BASELINES[algo]
        fn = functools.partial(
            round_fn, cfg_cls(n_nodes=n, degree=degree, lr=lr), binding,
            topo_cfg=topo, fault_cfg=faults)
        if adaptive:    # the rings have no topology stream of their own
            topology_draw = "policy" if topology_draw else "policy_at"

        def init_state(draws, device):
            return init_baseline_state(
                binding, n, params=draws.baseline_init(binding),
                extra=init_dac_extra(n) if algo == "dac" else None,
                device=device)

        return AlgoProgram(
            init_state=init_state, round_fn=fn, warmup_fn=fn,
            models_of=lambda s: s.params, finalize=lambda s: s,
            track_cluster=False, topology_draw=topology_draw,
            mixable_of=lambda s: s.params,
            # DEPRL sends its core alone
            sent_of=(lambda s: split.split_params(
                s.params, binding.head_keys)[0]) if algo == "deprl"
            else (lambda s: s.params), sent_lead=1)
    raise ValueError(f"algorithm {algo!r} is not ported yet; the port "
                     f"runs {ALGOS}")


def _facade_sent(s) -> dict:
    return {"cores": s.cores, "heads": s.heads, "cluster_id": s.cluster_id}


def algo_setup(algo: str, binding: Binding, draws, n: int, k: int, *,
               degree: int, lr: float, head_jitter: float = 0.0,
               device="cuda") -> AlgoSetup:
    """One run's :class:`AlgoSetup`, its initial state from ``draws``."""
    return algo_program(algo, binding, n, k, degree=degree, lr=lr,
                        head_jitter=head_jitter).setup(
        draws, device_mod.resolve(device))


# --------------------------------------------------------------------------
def make_evaluator(binding: Binding, node_cluster, test_x, test_y,
                   batch: int = 256, device="cuda", mesh=None) -> Callable:
    """Per-cluster evaluator: every node of a cluster runs the cluster's
    whole test set (zero-padded, masked eval batches), all of the cluster's
    nodes in one node-stacked forward per batch.

    Returns ``evaluate(models) -> (acc_per_cluster, preds_c, labels_c,
    node_acc)``: per-cluster mean node accuracy, the first node's
    predictions per cluster (for DP/EO), the labels, and the per-node
    accuracy ``[n]``. Clusters with no node are skipped;
    ``evaluate.cluster_ids`` says which cluster each entry is.

    ``evaluate.begin(models)`` / ``evaluate.finish(pending)`` split the
    call at the host boundary: ``begin`` enqueues every cluster's
    prediction and their copy to the host (a
    :class:`~repro_torch.device.HostCopy`) and makes no host sync;
    ``finish`` waits for that copy and reduces on the host. The pipelined
    driver dispatches the next segment in between. ``evaluate(models)``
    is ``finish(begin(models))``.

    ``mesh`` (a live node mesh): ``models`` hold the rank's block of
    nodes, each rank predicts for its own nodes, and ``begin`` gathers
    every node's predictions (one collective, rank blocks padded to one
    size) before their copy, so ``finish`` reduces what ``mesh=None``
    reduces.
    """
    dev = device_mod.resolve(device)
    node_cluster = np.asarray(node_cluster)
    n = node_cluster.shape[0]
    lo, m = (0, n) if mesh is None else meshctx.block(mesh, n)
    clusters, picks = [], {}
    for c in range(len(test_x)):
        idx = np.where(node_cluster == c)[0]
        if idx.size == 0:
            continue        # empty cluster: nothing to evaluate
        x = np.asarray(test_x[c])
        xb, mask = pipeline_mod.padded_eval_batches(
            x, min(batch, max(1, x.shape[0])))
        mine = idx
        if mesh is not None:
            # this rank's nodes of the cluster, and where every node's
            # predictions land in the gathered [P * m] padded blocks
            mine = idx[(idx >= lo) & (idx < lo + m)] - lo
            start = (idx // m) * m              # each node's block
            picks[len(clusters)] = torch.from_numpy(
                start + np.arange(idx.size) - np.searchsorted(idx, start)
            ).to(dev)
        clusters.append((idx, torch.from_numpy(mine).to(dev),
                         torch.from_numpy(xb).to(dev),
                         mask.reshape(-1) > 0, np.asarray(test_y[c])))

    @torch.no_grad()
    def predict(models_c, m: int, xb):               # xb [nb, B, ...]
        preds = [binding.forward(models_c, x.expand((m,) + x.shape))
                 .argmax(-1) for x in xb]
        return torch.stack(preds)                    # [nb, m, B]

    def begin(models) -> HostCopy:
        if mesh is None:
            return HostCopy({i: predict(tree_map(lambda l: l[idx_t],
                                                 models), len(idx), xb)
                             for i, (idx, idx_t, xb, _, _) in
                             enumerate(clusters)})
        padded = {}
        for i, (_, mine, xb, _, _) in enumerate(clusters):
            out = torch.zeros((m,) + (xb.shape[0], xb.shape[1]),
                              dtype=torch.long, device=dev)
            if mine.numel():
                out[:mine.numel()] = predict(
                    tree_map(lambda l: l[mine], models), mine.numel(),
                    xb).transpose(0, 1)
            padded[str(i)] = out                     # [m, nb, B]
        whole = meshctx.gather_tree(padded, mesh)    # [P * m, nb, B]
        return HostCopy({i: whole[str(i)][picks[i]].transpose(0, 1)
                         for i in range(len(clusters))})

    def finish(pending: HostCopy):
        preds = pending.wait()
        accs, preds_c, labels_c = [], [], []
        node_acc = np.zeros(node_cluster.shape[0], np.float64)
        for i, (idx, _, _, valid, y) in enumerate(clusters):
            p = preds[i].numpy()
            p = np.moveaxis(p, 1, 0).reshape(len(idx), -1)[:, valid]
            eq = p == y[None, :]
            accs.append(float(eq.mean()))
            node_acc[idx] = eq.mean(axis=1)
            preds_c.append(p[0])
            labels_c.append(y)
        return accs, preds_c, labels_c, node_acc

    def evaluate(models):
        return finish(begin(models))

    evaluate.begin = begin
    evaluate.finish = finish
    evaluate.cluster_ids = tuple(int(node_cluster[c[0][0]])
                                 for c in clusters)
    return evaluate


# --------------------------------------------------------------------------
class _History:
    """Bookkeeping of one run: comm log, eval histories, weighted mean
    accuracy and the target-accuracy stop condition."""

    def __init__(self, node_cluster, n: int, evaluator, models_of,
                 target_acc, verbose: bool, algo: str, n_classes: int,
                 tiers=None, obs=None):
        self.comm = CommLog()
        self.acc_hist, self.fair_hist, self.cluster_hist = [], [], []
        self.dp = self.eo = 0.0
        self.accs = []
        self.node_acc = None
        self.eval_frames = []
        self._prev_eval_cid = None
        self._weights = np.asarray(node_cluster)
        self._n = n
        self._evaluator = evaluator
        self._models_of = models_of
        self._target = target_acc
        self._verbose = verbose
        self._algo = algo
        self._n_classes = n_classes
        self._tiers = tiers
        self._obs = obs

    def eval_begin(self, state):
        """Enqueue the eval of ``state``: every cluster's prediction and,
        for FACADE, a copy of the state's cluster ids, each on its way to
        the host (:class:`~repro_torch.device.HostCopy`), with no host
        sync. Settle it with :meth:`eval_finish`. Enqueued before the
        next segment's replays on the same stream, they read this
        segment's state, which those replays then overwrite in place."""
        cid = getattr(state, "cluster_id", None)
        if cid is not None and meshctx.current() is not None:
            cid = meshctx.gather_tree(cid)      # every rank's block
        return (self._evaluator.begin(self._models_of(state)),
                None if cid is None else HostCopy(cid))

    def eval_round(self, state, rnd: int, round_bytes: float,
                   round_s: float = 0.0) -> bool:
        """Evaluate at round ``rnd`` (1-based), record, and report whether
        ``target_acc`` is reached (the run then stops)."""
        return self.eval_finish(self.eval_begin(state), rnd, round_bytes,
                                round_s)

    def eval_finish(self, pending, rnd: int, round_bytes: float,
                    round_s: float = 0.0) -> bool:
        pending, cid = pending
        accs, preds_c, labels_c, node_acc = self._evaluator.finish(pending)
        cids = self._evaluator.cluster_ids
        self.accs = accs
        self.node_acc = node_acc
        self.acc_hist.append((rnd, accs))
        mean_acc = float(np.mean(
            [a * (self._weights == c).sum()
             for c, a in zip(cids, accs)]) * len(accs) / self._n)
        eval_cid = None if cid is None else cid.wait().numpy()
        frame = compute_eval_frame(
            rnd, accs, cids, preds_c, labels_c, node_acc, self._n_classes,
            mean_acc=mean_acc, tiers=self._tiers,
            prev_cid=self._prev_eval_cid, cid=eval_cid)
        self._prev_eval_cid = eval_cid
        self.eval_frames.append(frame)
        if self._obs is not None:
            self._obs.record_eval(frame)
        self.fair_hist.append((rnd, frame.fair_acc))
        self.dp = frame.dp
        self.eo = frame.eo
        self.comm.record(rnd, round_bytes, mean_acc, round_s=round_s)
        if self._verbose:
            print(f"  [{self._algo}] round {rnd}: acc={accs} "
                  f"fair={frame.fair_acc:.3f}")
        return self._target is not None and mean_acc >= self._target

    def result(self, algo: str, models) -> RunResult:
        history = [(r, c.cpu().numpy().astype(np.int32))
                   for r, c in self.cluster_hist]
        return RunResult(algo=algo, acc_per_cluster=self.acc_hist,
                         fair_acc=self.fair_hist, dp=self.dp, eo=self.eo,
                         comm=self.comm, cluster_history=history,
                         final_acc=self.accs, node_acc=self.node_acc,
                         eval_frames=self.eval_frames, models=models)


# --------------------------------------------------------------------------
def run_experiment(algo: str, cfg, dataset, *, rounds: int,
                   k: int | None = None, degree: int = 4,
                   local_steps: int = 10, batch_size: int = 8,
                   lr: float = 0.05, eval_every: int = 20, seed: int = 0,
                   warmup_rounds: int = 0, head_jitter: float = 0.0,
                   target_acc: float | None = None, eval_batch: int = 256,
                   verbose: bool = False, device="cuda", draws=None,
                   engine: bool = True, pipeline: bool = False,
                   cache: EngineCache | None = None,
                   ckpt: str | None = None,
                   net: "netsim.NetworkConfig | None" = None,
                   topo: "topo_mod.TopoConfig | None" = None,
                   obs=None, mesh=None) -> RunResult:
    """Run one (algorithm, dataset) experiment end to end on ``device``.

    ``algo`` is one of :data:`ALGOS`. ``draws`` supplies the initial
    parameters, batch indices and topology draws (default
    ``TorchDraws(seed)``); it has the methods of :class:`TorchDraws`.

    ``engine``: ``True`` runs the segment engine (:mod:`.engine`: on CUDA
    each eval-to-eval span replays one captured round, with one host
    transfer a span); ``False`` the per-round loop. On one device both
    give the same run bit for bit.

    ``net``: a :class:`repro_torch.netsim.NetworkConfig` (for example
    ``NetworkConfig.preset("edge-churn")``) simulates message loss, churn,
    stragglers, bursty links, link tiers and async stale gossip for any
    algorithm on either driver; the ``CommLog`` then counts the bytes
    actually delivered and carries simulated seconds beside them, and the
    eval frames split accuracy by link tier. ``None`` is the ideal-medium
    path. ``net.faults`` (a :class:`repro_torch.resil.FaultConfig`) adds
    node crashes and restarts, payload corruption and the robust guard,
    on both drivers; ``None`` and every zero-rate off-switch are the
    fault-free run bit for bit.

    ``topo``: a :class:`repro_torch.topo.TopoConfig`, an adaptive
    topology policy (per-link delivery and link-time EWMAs, carried like
    the channel, driving a participation-gated Gumbel-top-k graph with a
    ``min_inclusion`` fairness floor) for any algorithm on either driver,
    with or without ``net`` (without it nothing is observed, the EWMAs
    stay neutral, and the bytes count the drawn graph's edges).
    ``None`` and ``TopoConfig()`` (``policy="uniform"``) are the run
    without a policy bit for bit.

    ``obs``: a :class:`repro_torch.obs.Obs`. Its ``config`` (an
    ``ObsConfig``, an ``EngineSpec`` key component) adds a per-round
    ``MetricsFrame``, computed on the run's device after the round (after
    the gossip fold and the policy's advance, before ``finalize``): inside
    the captured round on the engine, its ``[L, F]`` rows drained with the
    segment's other outputs, and the same function a round on the loop,
    so the two drivers' frames are equal bit for bit. Its tracer wraps the
    run in spans (``run``, ``cache.entry``, ``compile``, ``dispatch``,
    ``drain``, ``eval``, ``ckpt.save``) and events (``run.begin``,
    ``cache.hit``/``cache.miss``, ``ckpt.resume``, ``health.<rule>``,
    ``run.end``); every eval's ``EvalFrame`` is recorded; at the end the
    run is judged by ``obs.health_config`` and a ``RunManifest`` (health,
    timing rollup, cache stats) is appended to ``obs.manifests`` and
    written under ``obs.out_dir``. Under ``ckpt`` each segment's frames go
    to a sidecar file (``<ckpt>.frames-<i>.npz``) written before the
    checkpoint, and a resumed run replays them into ``obs``. ``None`` is
    the run without telemetry, and an enabled ``Obs`` observes that same
    run bit for bit: the frame only reads.

    ``pipeline`` (engine only): dispatch segment t+1 before segment t is
    drained, so the host's work on segment t (the drain, the eval's
    reduction, the histories, a checkpoint write) and t+1's draws overlap
    t+1's replays on the card. Everything runs on one stream: segment t's
    eval and its copies to the host are enqueued before t+1's replays,
    which then overwrite the state in place, and the host waits on events
    recorded behind those copies, never on the stream. The run is
    ``pipeline=False``'s bit for bit; a ``target_acc`` hit abandons the
    one segment dispatched ahead (its rounds ran on the card, and the
    result keeps the models of the eval that hit).

    ``cache``: an :class:`EngineCache` shared across calls, so that the
    runs of one configuration capture their rounds and build their
    evaluator once; ``None`` uses a fresh private cache.

    ``ckpt`` (engine only): a checkpoint path. After every segment the
    state, the draws source's state (its ``state()``, which a ``draws``
    passed here must have) and the histories are written atomically
    (:mod:`repro_torch.checkpoint`); the same call with the same path
    resumes after the last segment written and ends bit for bit as the
    uninterrupted run, with either driver. A checkpoint written by another
    configuration is refused (a fingerprint over the :class:`EngineSpec`,
    the seed, rounds, eval schedule, warmup, target and the draws
    source's class). The spec holds the device, so a checkpoint written
    on the card is refused on the CPU, as the reference's spec holds its
    mesh.

    ``mesh`` (engine only): shard the node axis over a 1-D node mesh, an
    int, a 1-tuple ``(P,)`` or a 1-D ``DeviceMesh`` (:mod:`.meshctx`;
    ``launch.mesh.make_node_mesh`` builds one). One process per card:
    every rank calls ``run_experiment`` with the same arguments, ``(P,)``
    with ``P > 1`` needs an initialised process group of ``P`` ranks
    (``torchrun``), and ``(1,)`` starts a one-rank group itself when none
    is. Each rank holds ``n / P`` nodes (``P`` must divide ``n``): it
    draws the whole run from the seed and keeps its rows, the round's
    ``[n]`` and ``[n, n]`` tensors are whole on every rank, and gossip
    mixes the rank's rows of the mixing matrix against the senders
    all-gathered once a round. Every rank returns the same result
    (``models`` gathered whole). ``mesh=(1,)`` is ``mesh=None``'s run bit
    for bit. On more ranks the bytes, seconds and frame counts are exact;
    the cross-node products run at ``mesh=None``'s shapes
    (``meshctx.pad_rows``), so the rest is exact where the device's
    grouped convolutions give a node the same result in a block of n / P
    nodes as in all n (an H100 does; the CPU's differ in the last ulp,
    and the runs then drift within a small tolerance). The mesh shape is an
    ``EngineSpec`` field, so it forks the cache and the checkpoint
    fingerprint; under ``ckpt`` rank 0 writes the gathered carry and
    every rank reads it back on resume.

    The run computes fp32 in full fp32 (TF32 off, as the reference) with
    cuDNN restricted to deterministic algorithms
    (:func:`device.deterministic`): with cuDNN's defaults two runs of one
    ResNet8 configuration on an H100 part in their parameters within 8
    rounds, and the engine could not be held to the loop. The caller's
    flags are restored when it returns or raises.
    """
    with device_mod.no_tf32(), device_mod.deterministic():
        return _run(algo, cfg, dataset, rounds=rounds, k=k, degree=degree,
                    local_steps=local_steps, batch_size=batch_size, lr=lr,
                    eval_every=eval_every, seed=seed,
                    warmup_rounds=warmup_rounds, head_jitter=head_jitter,
                    target_acc=target_acc, eval_batch=eval_batch,
                    verbose=verbose, device=device, draws=draws,
                    engine=engine, pipeline=pipeline, cache=cache,
                    ckpt=ckpt, net=net, topo=topo, obs=obs, mesh=mesh)


def _run(algo: str, cfg, dataset, *, rounds: int, k, degree: int,
         local_steps: int, batch_size: int, lr: float, eval_every: int,
         seed: int, warmup_rounds: int, head_jitter: float, target_acc,
         eval_batch: int, verbose: bool, device, draws, engine: bool,
         pipeline: bool, cache, ckpt, net, topo, obs, mesh) -> RunResult:
    if ckpt is not None and not engine:
        raise ValueError(
            "ckpt= needs the segment engine (engine=True): the legacy "
            "per-round loop has no segment boundaries to snapshot at")
    if pipeline and not engine:
        raise ValueError(
            "pipeline=True needs the segment engine (engine=True): the "
            "legacy per-round loop has no segment dispatch to overlap")
    mesh = meshctx.normalize(mesh)
    if mesh is not None and not engine:
        raise ValueError(
            "mesh= needs the segment engine (engine=True): the per-round "
            "loop is the single-device parity reference and never shards")
    if algo not in ALGOS:
        raise ValueError(f"algorithm {algo!r} is not ported yet; the port "
                         f"runs {ALGOS}")
    if net is not None and not isinstance(net, netsim.NetworkConfig):
        raise TypeError(f"net must be a netsim.NetworkConfig or None, not "
                        f"{type(net).__name__}")
    if net is not None and net.faults is not None and not isinstance(
            net.faults, resil.FaultConfig):
        raise TypeError(f"net.faults must be a resil.FaultConfig or None, "
                        f"not {type(net.faults).__name__}")
    if topo is not None and not isinstance(topo, topo_mod.TopoConfig):
        raise TypeError(f"topo must be a topo.TopoConfig or None, not "
                        f"{type(topo).__name__}")
    if eval_every <= 0:
        raise ValueError(
            f"eval_every={eval_every} must be a positive round count")
    if target_acc is not None and eval_every > rounds:
        raise ValueError(
            f"target_acc={target_acc} can never trigger an early exit with "
            f"eval_every={eval_every} > rounds={rounds}")
    n = dataset.n_nodes
    if mesh is not None and n % mesh[0] != 0:
        raise ValueError(
            f"mesh={mesh} must divide n={n} nodes evenly: the engine "
            "row-shards the node axis in equal blocks per rank")
    for r in sorted({degree, topo_mod.budget(topo, degree)}):
        if not 1 <= r < n:
            raise ValueError(f"degree={r} out of range for n={n} nodes: "
                             "pick 1 <= degree <= n - 1")
    if algo != "facade":
        warmup_rounds = 0       # only FACADE has a warmup phase; keeps the
        #                         baselines' cache keys from forking
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    k = k if k is not None else dataset.k
    draws = draws if draws is not None else TorchDraws(seed)
    if ckpt is not None and not hasattr(draws, "state"):
        raise ValueError(
            f"ckpt= needs a draws source with state()/set_state(): the "
            f"run's randomness lives in it, and {type(draws).__name__} "
            "cannot be saved, so a resume could not draw what the "
            "uninterrupted run draws")
    cache = cache if cache is not None else EngineCache()
    tracer = obs.tracer if obs is not None else None
    ocfg = obs.config if obs is not None else None
    spec = EngineSpec(algo=algo, cfg=cfg, n=n, k=k, degree=degree,
                      local_steps=local_steps, batch_size=batch_size, lr=lr,
                      warmup_rounds=warmup_rounds, head_jitter=head_jitter,
                      eval_batch=eval_batch, device=dev, net=net,
                      topo=topo, obs=ocfg, mesh=mesh)
    ckpt_fp = None
    if ckpt is not None:
        # everything that shapes the trajectory or the resume schedule; a
        # checkpoint of any other configuration is refused. On a mesh the
        # ranks' cards differ: the fingerprint holds the device type
        fp_spec = spec if mesh is None else dataclasses.replace(
            spec, device=torch.device(dev.type))
        ckpt_fp = fingerprint({
            "spec": repr(fp_spec), "seed": seed, "rounds": rounds,
            "eval_every": eval_every, "warmup_rounds": warmup_rounds,
            "target": repr(target_acc), "draws": type(draws).__name__,
            "net": repr(net)})
    if obs is not None:
        obs.begin_run(algo=algo, seed=seed, rounds=rounds, engine=engine)
    misses0 = cache.misses
    with span(tracer, "cache.entry", algo=algo):
        entry = cache.entry(spec, tracer=tracer)
    if tracer is not None:
        tracer.event("cache.miss" if cache.misses > misses0
                     else "cache.hit", algo=algo, seed=seed)
    # pinned while the run is live: an LRU-bounded cache must never evict
    # the engine whose static buffers the run is using
    with obs.profile() if obs is not None else contextlib.nullcontext(), \
            cache.pin(spec), meshctx.activate(entry.engine.mesh), \
            span(tracer, "run", algo=algo, seed=seed, engine=engine):
        setup = entry.setup(draws)
        builds0 = cache.evaluator_builds
        evaluator = cache.evaluator(entry.binding, dataset,
                                    batch=eval_batch, device=dev,
                                    mesh=entry.engine.mesh)
        if tracer is not None and cache.evaluator_builds > builds0:
            tracer.event("evaluator.build", batch=eval_batch)
        sched = None if net is None else netsim.NetSchedule(
            net, n, draws, noise=resil.noise_spec(
                net, setup.program.sent_of(setup.state),
                setup.program.sent_lead))
        tiers = None if net is None else tiers_of(net, n, draws)
        hist = _History(dataset.node_cluster, n, evaluator,
                        setup.program.models_of, target_acc, verbose, algo,
                        cfg.n_classes, tiers=tiers, obs=obs)
        # the frame's tier vector, moved to the device once a run
        frame_tiers = (torch.from_numpy(tiers).to(dev)
                       if ocfg is not None and tiers is not None else None)
        carry = _initial_carry(setup, sched, n, dev, topo)
        if engine:
            train_x, train_y = entry.engine.place_data(dataset)
            models = _drive_engine(
                entry.engine, setup.program, carry, hist, draws, train_x,
                train_y, rounds=rounds, eval_every=eval_every,
                warmup_rounds=warmup_rounds, target_acc=target_acc,
                ckpt=ckpt, ckpt_fp=ckpt_fp, pipeline=pipeline, sched=sched,
                obs=obs, tiers=frame_tiers)
        else:
            train_x, train_y = pipeline_mod.place(dataset, dev)
            state = _drive_loop(setup.program, carry, hist, draws, train_x,
                                train_y, rounds=rounds,
                                eval_every=eval_every,
                                warmup_rounds=warmup_rounds,
                                local_steps=local_steps,
                                batch_size=batch_size, n=n, degree=degree,
                                sched=sched, topo=topo, obs=obs,
                                tiers=frame_tiers)
            models = setup.program.models_of(state)
    if obs is not None:
        _end_run(obs, spec, cache, algo=algo, seed=seed, n=n, rounds=rounds,
                 eval_every=eval_every, engine=engine, pipeline=pipeline,
                 warmup_rounds=warmup_rounds, net=net, topo=topo)
    return hist.result(algo, models)


def _end_run(obs, spec: EngineSpec, cache: EngineCache, *, algo: str,
             seed: int, n: int, rounds: int, eval_every: int, engine: bool,
             pipeline: bool, warmup_rounds: int, net, topo):
    """A run's end under ``obs``: judge its frames and evals against
    ``obs.health_config`` (firing ``health.<rule>`` events) and append its
    :class:`~repro_torch.obs.RunManifest` (health, the tracer's timing
    rollup, the cache's stats) to ``obs``, as the reference's run does."""
    health = None
    if obs.health_config is not None:
        ctx = HealthContext(
            n=n, warmup_rounds=warmup_rounds,
            inclusion_floor=(topo.min_inclusion
                             if topo_mod.adaptive(topo) else None),
            faults=net is not None and net.faults is not None)
        health = evaluate_health(
            obs.health_config, ctx, obs.run_frames_table(),
            obs.run_eval_table(), tracer=obs.tracer).to_json()
    sink_path = getattr(obs.sink, "path", None)
    obs.end_run(RunManifest.build(
        kind="run", name=f"{algo}-seed{seed}", spec=spec,
        settings={"rounds": rounds, "eval_every": eval_every,
                  "engine": engine, "pipeline": pipeline, "seed": seed,
                  "net": repr(net), "topo": repr(topo),
                  "obs": repr(obs.config),
                  "jsonl": None if sink_path is None else str(sink_path)},
        timing=obs.tracer.rollup(), cache=cache.stats(), health=health))


def _initial_carry(setup: AlgoSetup, sched, n: int, dev,
                   topo=None) -> EngineCarry:
    """The run's initial carry: the state and, under ``net`` (``sched``,
    its :class:`~repro_torch.netsim.NetSchedule`), the channel drawn from
    its stationary distribution, a fresh async-gossip buffer and a fresh
    crash chain (every node up; under ``reset`` a copy of the state), and
    under an adaptive ``topo`` the policy's neutral ``TopoState``."""
    tstate = topo_mod.init_state(topo, None if sched is None else
                                 sched.cfg, n, dev)
    if sched is None:
        return EngineCarry(setup.state, topo=tstate)
    return EngineCarry(
        setup.state, sched.init_channel(dev),
        netsim.init_gossip(sched.cfg, n,
                           setup.program.mixable_of(setup.state)),
        resil.init_state(sched.cfg, n, setup.state), tstate)


def _drive_loop(program: AlgoProgram, carry: EngineCarry, hist: _History,
                draws, train_x, train_y, *, rounds, eval_every,
                warmup_rounds, local_steps, batch_size, n, degree,
                sched=None, topo=None, obs=None, tiers=None):
    """The per-round loop: every round drawn, run and recorded on its own;
    under ``net`` the channel, the gossip buffer and the crash chain, and
    under an adaptive ``topo`` (the run's ``TopoConfig``) the policy's
    EWMAs, are threaded through as the engine carries them. Under
    ``obs.config`` each round's frame comes from the engine's hook
    (``obs.frame_hook``, with ``tiers`` the run's tier vector on the
    device or ``None``) at the engine's point of the round, and is
    recorded before the eval. Returns the final state."""
    state, chan, gossip, fault, tstate = carry
    dev = train_x.device
    per_node = train_x.shape[1]
    tracer = obs.tracer if obs is not None else None
    ocfg = obs.config if obs is not None else None
    hook = None
    if ocfg is not None:
        hook = frame_hook(ocfg, n, tiers if tiers is not None else
                          torch.zeros((n,), dtype=torch.float32, device=dev),
                          program.mixable_of)

    def draw_topology(rnd: int) -> tuple:
        """The round's topology draw, which follows the algorithm (the
        reference splits its key only for a round that uses it)."""
        if program.topology_draw == "perms":
            return (draws.perms(n, degree).to(dev),)
        if program.topology_draw == "gumbel":
            return (draws.gumbel(n).to(dev),)
        if program.topology_draw == "policy":
            return (draws.policy_draw(n).to(dev),)
        if program.topology_draw == "policy_at":
            return (topo_mod.static_draw(topo, rnd, n, draws).to(dev),)
        return ()

    for rnd in range(rounds):
        idx = draws.batch_indices(n, local_steps, batch_size, per_node)
        batches = pipeline_mod.sample_round_batches(idx.to(dev), train_x,
                                                    train_y)
        fn = program.warmup_fn if rnd < warmup_rounds else program.round_fn
        round_s = 0.0
        if sched is None:
            prev = state
            state, info = fn(prev, batches, *draw_topology(rnd),
                             **netwire.topo_kw(tstate))
            if hook is not None:
                info["frame"] = hook(prev, state, info, None, None)
        else:
            (state, chan, gossip, fault, tstate, info,
             round_s) = netwire.net_round(
                fn, program.mixable_of, state, chan, gossip, fault, batches,
                draw_topology(rnd), sched.cfg, sched.round(rnd).to(dev),
                local_steps, topo_cfg=topo, topo=tstate, frame=hook)
            round_s = float(round_s)
        if hook is not None:
            obs.record_frames([rnd + 1], frames_of_rows(
                info["frame"][None].cpu().numpy(), ocfg))
        round_bytes = float(info["round_bytes"])
        last_round = rnd == rounds - 1
        if last_round:
            state = program.finalize(state)
        if (rnd + 1) % eval_every == 0 or last_round:
            with span(tracer, "eval", round=rnd + 1):
                hit = hist.eval_round(state, rnd + 1, round_bytes, round_s)
            if hit:
                break
        else:
            hist.comm.record(rnd + 1, round_bytes, round_s=round_s)
        if program.track_cluster:
            hist.cluster_hist.append((rnd + 1, state.cluster_id))
    return state


def _final_models(program: AlgoProgram, state):
    """The run's deployable models as copies: the state's tensors are the
    engine's static buffers, which a later run of its entry overwrites.
    On a node mesh, every rank's block gathered whole."""
    if meshctx.current() is not None:
        return meshctx.gather_tree(program.models_of(state))
    return tree_map(torch.clone, program.models_of(state))


def _settle(hist: _History, program: AlgoProgram, seg, outs, ev,
            obs=None) -> bool:
    """The host's work on a drained segment, in the loop's order: its
    frames (under ``obs.config``, the whole segment's, also on a hit), its
    bytes and simulated seconds, the eval at its end (``ev``, from
    ``hist.eval_begin``) and FACADE's cluster ids. Returns whether
    ``target_acc`` was reached; the cluster history then ends a round
    earlier, as the loop breaks before appending the eval round's ids."""
    rnds = np.arange(seg.start + 1, seg.start + seg.length + 1)
    if obs is not None and "frame" in outs:
        obs.record_frames(rnds, outs["frame"])
    rb = outs["round_bytes"]
    rs = outs.get("round_s")
    if rs is None:
        rs = np.zeros_like(rb)
    hit = False
    if seg.eval_at_end:
        hist.comm.record_bulk(rnds[:-1], rb[:-1], rs[:-1])
        with span(None if obs is None else obs.tracer, "eval",
                  round=int(rnds[-1])):
            hit = hist.eval_finish(ev, int(rnds[-1]), float(rb[-1]),
                                   float(rs[-1]))
    else:
        hist.comm.record_bulk(rnds, rb, rs)
    if program.track_cluster:
        upto = len(rnds) - 1 if hit else len(rnds)
        hist.cluster_hist.extend(
            (int(rnds[i]), outs["cluster_id"][i]) for i in range(upto))
    return hit


def _eval_state(program: AlgoProgram, seg, carry, rounds: int, hist):
    """At the end of an eval segment: the carry, finalized after the run's
    last round, and its eval begun (``None`` for a segment without an
    eval)."""
    if not seg.eval_at_end:
        return carry, None
    if seg.start + seg.length == rounds:
        carry = carry._replace(state=program.finalize(carry.state))
    return carry, hist.eval_begin(carry.state)


def _drive_engine(eng: SegmentEngine, program: AlgoProgram,
                  carry: EngineCarry, hist: _History, draws, train_x,
                  train_y, *, rounds, eval_every, warmup_rounds,
                  target_acc=None, ckpt=None, ckpt_fp=None, pipeline=False,
                  sched=None, obs=None, tiers=None):
    """Segment-engine driver: one dispatch and one host transfer per span
    (the reference's ``_drive_engine``). ``pipeline`` hands the segments
    to :func:`_drive_pipelined`; otherwise each is dispatched, drained and
    settled before the next. A ``target_acc`` hit stops at the eval that
    reaches it.

    ``ckpt``: after every segment the carry (the state and, under
    ``net``, the channel and the gossip buffer), the draws source's state
    and the histories are saved (:func:`_ckpt_save`); on entry a
    checkpoint at that path with a matching fingerprint fast-forwards the
    run to the segment after the last one saved, its carry loaded into
    the engine's static buffers through ``init_carry``, and its frame
    sidecars replayed into ``obs``. ``sched``: the run's
    :class:`~repro_torch.netsim.NetSchedule` under ``net``. ``obs``: the
    run's ``Obs`` (its tracer's spans, each segment's frames) and
    ``tiers`` the frame's tier vector on the device (``None``: all core).
    Returns the final models (copies)."""
    tracer = obs.tracer if obs is not None else None
    plan = segment_plan(rounds, eval_every, warmup_rounds)
    start_idx, finished, n_frames = 0, False, 0
    if ckpt is not None and os.path.exists(ckpt):
        carry, start_idx, finished, n_frames = _ckpt_resume(
            ckpt, ckpt_fp, carry, draws, hist, obs)
    carry = eng.init_carry(*carry, tiers=tiers)
    if finished:
        return _final_models(program, carry.state)
    if pipeline:
        return _drive_pipelined(eng, program, hist, draws, carry, plan,
                                start_idx, train_x, train_y, rounds=rounds,
                                target_acc=target_acc, ckpt=ckpt,
                                ckpt_fp=ckpt_fp, sched=sched, obs=obs,
                                n_frames=n_frames)
    for idx in range(start_idx, len(plan)):
        seg = plan[idx]
        carry, outs = eng.run_segment(carry, seg.start, seg.length,
                                      train_x, train_y, draws,
                                      warmup=seg.warmup, net=sched,
                                      tracer=tracer)
        carry, ev = _eval_state(program, seg, carry, rounds, hist)
        hit = _settle(hist, program, seg, outs, ev, obs)
        if ckpt is not None:
            finished = hit or idx + 1 == len(plan)
            with span(tracer, "ckpt.save", segment=idx, finished=finished):
                snap = _carry_snapshot(eng.whole_carry(carry))
                n_frames = _ckpt_save(ckpt, ckpt_fp, snap, draws.state(),
                                      hist, idx + 1, finished,
                                      _seg_frames(seg, outs), n_frames)
        if hit:
            break
    return _final_models(program, carry.state)


def _seg_frames(seg, outs):
    """``(rounds, MetricsFrame)`` of a drained segment, or ``None``
    without frames: what its checkpoint's sidecar holds."""
    if "frame" not in outs:
        return None
    return np.arange(seg.start + 1, seg.start + seg.length + 1), outs["frame"]


def _drive_pipelined(eng: SegmentEngine, program: AlgoProgram,
                     hist: _History, draws, carry, plan, start_idx: int,
                     train_x, train_y, *, rounds, target_acc, ckpt,
                     ckpt_fp, sched=None, obs=None, n_frames: int = 0):
    """Double-buffered segment loop (the reference's ``_drive_pipelined``):
    while the host drains and settles segment t, the card runs segment
    t+1. Per segment, in this order:

    1. segment t's eval is begun (its forwards and their copies to the
       host enqueued), and, under ``ckpt``, the state's copy to the host;
    2. segment t+1 is dispatched: its draws taken on the host, its
       replays enqueued behind step 1 on the same stream, so they
       overwrite the state only after step 1 has read it;
    3. segment t is drained and settled (bytes, eval, cluster history,
       checkpoint), each wait on an event behind step 1's copies, never
       on the stream;
    4. a ``target_acc`` hit returns and abandons segment t+1.

    The draws source's state goes into segment t's checkpoint as it was
    right after t was dispatched: t+1's dispatch draws before t's
    checkpoint is written. ``eng.overlapped`` counts the segments whose
    successor was still on the card when step 3 ended. ``obs`` and
    ``n_frames`` (the frame sidecars already written) as in
    :func:`_drive_engine`. Returns the final models (copies)."""
    tracer = obs.tracer if obs is not None else None

    def dispatch(i, c):
        s = plan[i]
        c, outs = eng.dispatch_segment(c, s.start, s.length, train_x,
                                       train_y, draws, warmup=s.warmup,
                                       net=sched, tracer=tracer)
        return c, outs, draws.state() if ckpt is not None else None

    next_carry, pending, drawn = dispatch(start_idx, carry)
    kept = None
    for idx in range(start_idx, len(plan)):
        seg, last = plan[idx], idx + 1 == len(plan)
        carry, ev = _eval_state(program, seg, next_carry, rounds, hist)
        if ev is not None and target_acc is not None and not last:
            # a hit returns this eval's models, which segment t+1's
            # replays overwrite in place
            kept = _final_models(program, carry.state)
        snap = (_carry_snapshot(eng.whole_carry(carry))
                if ckpt is not None else None)
        nxt = None
        if not last:
            next_carry, nxt, next_drawn = dispatch(idx + 1, carry)
        outs = eng.drain(pending, tracer=tracer, length=seg.length)
        hit = _settle(hist, program, seg, outs, ev, obs)
        if ckpt is not None:
            with span(tracer, "ckpt.save", segment=idx,
                      finished=hit or last):
                n_frames = _ckpt_save(ckpt, ckpt_fp, snap, drawn, hist,
                                      idx + 1, hit or last,
                                      _seg_frames(seg, outs), n_frames)
        if nxt is not None and nxt["end"] is not None \
                and not nxt["end"].query():
            eng.overlapped += 1
        if hit:
            return kept if not last else _final_models(program, carry.state)
        if not last:
            pending, drawn = nxt, next_drawn
    return _final_models(program, carry.state)


# --------------------------------------------------------------------------
def _hist_snapshot(hist: _History) -> dict:
    """The :class:`_History` as a checkpoint tree (numpy arrays and
    tensors); the inverse of :func:`_hist_restore`. float64 and int64
    round-trip exactly, so a restored history is the live one bit for
    bit."""
    c = hist.comm
    return {
        "comm": {"rounds": np.asarray(c.rounds, np.int64),
                 "bytes": np.asarray(c.bytes, np.float64),
                 "seconds": np.asarray(c.seconds, np.float64),
                 "acc": np.asarray(c.acc, np.float64),
                 "evaled": np.asarray(c.evaled, np.bool_)},
        "acc_hist": [{"round": np.asarray(r, np.int64),
                      "accs": np.asarray(a, np.float64)}
                     for r, a in hist.acc_hist],
        "fair_hist": {
            "rounds": np.asarray([r for r, _ in hist.fair_hist], np.int64),
            "vals": np.asarray([v for _, v in hist.fair_hist], np.float64)},
        "cluster_hist": [{"round": np.asarray(r, np.int64), "cid": cid}
                         for r, cid in hist.cluster_hist],
        "dp": np.asarray(hist.dp, np.float64),
        "eo": np.asarray(hist.eo, np.float64),
        "accs": np.asarray(hist.accs, np.float64),
        "node_acc": hist.node_acc,
        # one dict of float64/int64 arrays per EvalFrame
        "eval_frames": [
            {name: np.asarray(getattr(f, name),
                              np.int64 if name in ("round", "cluster_ids")
                              else np.float64)
             for name in EvalFrame._fields}
            for f in hist.eval_frames],
        "prev_eval_cid": hist._prev_eval_cid,
    }


def _hist_restore(hist: _History, snap: dict):
    """Rehydrate ``hist`` from a loaded :func:`_hist_snapshot` tree (CPU
    tensors), with the Python containers the drivers append (lists of
    ints, floats and tuples), so that a resumed run's result cannot be
    told from an uninterrupted one's."""
    c, comm = hist.comm, snap["comm"]
    c.rounds = comm["rounds"].tolist()
    c.bytes = comm["bytes"].tolist()
    c.seconds = comm["seconds"].tolist()
    c.acc = comm["acc"].tolist()
    c.evaled = comm["evaled"].tolist()
    hist.acc_hist = [(int(e["round"]), e["accs"].tolist())
                     for e in snap["acc_hist"]]
    hist.fair_hist = list(zip(snap["fair_hist"]["rounds"].tolist(),
                              snap["fair_hist"]["vals"].tolist()))
    hist.cluster_hist = [(int(e["round"]), e["cid"])
                         for e in snap["cluster_hist"]]
    hist.dp = float(snap["dp"])
    hist.eo = float(snap["eo"])
    hist.accs = snap["accs"].tolist()
    hist.node_acc = (None if snap["node_acc"] is None
                     else snap["node_acc"].numpy())
    hist.eval_frames = [
        EvalFrame(**{name: (tuple(e[name].reshape(-1).tolist())
                            if name in ("acc", "cluster_ids")
                            else e[name].item())
                     for name in EvalFrame._fields})
        for e in snap["eval_frames"]]
    prev = snap["prev_eval_cid"]
    hist._prev_eval_cid = None if prev is None else prev.numpy()


def _carry_snapshot(carry: EngineCarry) -> tuple:
    """``(round, HostCopy of the carry's tensors)``: the carry on its way
    to the host, taken where it stands on the stream. The tensors are
    ``{"state": the state's, "net": {"chan": ..., "gossip": {"published",
    "age"}, "fault": {"down", "init"}}, "topo": {"delivery", "link_s"}}``,
    ``net`` holding only what the run carries (``init``, the state's
    tensors, under ``reset``) and ``topo`` empty without an adaptive
    policy."""
    net = {}
    if carry.chan is not None:
        net["chan"] = carry.chan.bad
    if carry.gossip is not None:
        net["gossip"] = dict(carry.gossip._asdict())
    if carry.fault is not None:
        net["fault"] = {"down": carry.fault.down}
        if carry.fault.init is not None:
            net["fault"]["init"] = state_tensors(carry.fault.init)
    topo = {} if carry.topo is None else dict(carry.topo._asdict())
    return carry.state.round, HostCopy({"state": state_tensors(carry.state),
                                        "net": net, "topo": topo})


def _frame_path(ckpt: str, index: int) -> str:
    """The path of a checkpoint's ``index``-th frame sidecar."""
    return f"{ckpt}.frames-{index}.npz"


def _ckpt_save(path: str, fp: str, snapshot: tuple, draws_state,
               hist: _History, next_segment: int, finished: bool,
               new_frames=None, n_frame_files: int = 0) -> int:
    """Write the whole resumable run at a segment boundary, atomically
    (:func:`repro_torch.checkpoint.save`): the carry (from
    :func:`_carry_snapshot`: the state under ``carry``, the network's
    channel, gossip buffer and crash chain under ``net``, the topology
    policy's EWMAs under ``topo``), the draws source's state
    after the saved segment's draws and the histories; the meta holds the
    fingerprint, the next segment, whether the run has finished, and
    ``frame_files``, how many frame sidecars are valid.

    ``new_frames``: this segment's ``(rounds, MetricsFrame)`` (under an
    ``ObsConfig``) or ``None``. Frames go to append-only sidecars
    (:func:`_frame_path`), one a segment, each written before the main
    archive that counts it, so a write costs the same at every segment
    and a crash between the two leaves an orphan the next run overwrites.
    On a node mesh (``snapshot`` holds the gathered carry) rank 0 writes
    and every rank waits at a barrier, so no rank runs ahead of a
    checkpoint that is not on disk. Returns the updated sidecar count."""
    mesh = meshctx.current()
    if mesh is not None and mesh.get_local_rank(0) != 0:
        snapshot[1].wait()
        dist.barrier(group=mesh.get_group(0))
        return n_frame_files + (new_frames is not None)
    if new_frames is not None:
        rnds, fr = new_frames
        checkpoint.save(
            _frame_path(path, n_frame_files),
            {"rounds": np.asarray(rnds, np.int64),
             "frame": {name: np.asarray(leaf)
                       for name, leaf in zip(MetricsFrame._fields, fr)}},
            meta={"fingerprint": fp, "index": int(n_frame_files)})
        n_frame_files += 1
    rnd, tensors = snapshot
    tensors = tensors.wait()
    checkpoint.save(path, {"carry": {"round": rnd, **tensors["state"]},
                           "net": tensors["net"],
                           "topo": tensors["topo"],
                           "draws": draws_state,
                           "hist": _hist_snapshot(hist)},
                    meta={"fingerprint": fp,
                          "next_segment": int(next_segment),
                          "finished": bool(finished),
                          "frame_files": int(n_frame_files)})
    if mesh is not None:
        dist.barrier(group=mesh.get_group(0))
    return n_frame_files


def _ckpt_resume(ckpt: str, fp: str, carry: EngineCarry, draws,
                 hist: _History, obs=None):
    """Fast-forward a checkpointed run: refuse a fingerprint mismatch,
    rebuild the carry on the freshly minted one (the state's type and its
    ``None`` fields), restore the draws source and the histories (each
    restored eval frame recorded into ``obs``), and replay every frame
    sidecar into ``obs``. Returns ``(carry, next_segment, finished,
    frame_files)``."""
    payload, meta = checkpoint.load(ckpt)
    if meta.get("fingerprint") != fp:
        raise ValueError(
            f"checkpoint {ckpt!r} was written by a different run "
            "configuration (fingerprint mismatch) — refusing to "
            "resume from it; delete the file or pick a fresh path")
    n_frame_files = int(meta.get("frame_files", 0))
    sidecars = []
    for j in range(n_frame_files):
        rec, fmeta = checkpoint.load(_frame_path(ckpt, j))
        if fmeta.get("fingerprint") != fp:
            raise ValueError(
                f"frame sidecar {_frame_path(ckpt, j)!r} does not match "
                f"checkpoint {ckpt!r} (fingerprint mismatch) — refusing "
                "to resume; delete the checkpoint files to restart")
        sidecars.append(rec)
    fields = dict(payload["carry"])
    fields["round"] = int(fields["round"])
    draws.set_state(payload["draws"])
    _hist_restore(hist, payload["hist"])
    if obs is not None:
        for frame in hist.eval_frames:
            obs.record_eval(frame)
        for rec in sidecars:
            obs.record_frames(rec["rounds"].numpy(), MetricsFrame(
                *(rec["frame"][name].numpy()
                  for name in MetricsFrame._fields)))
        obs.tracer.event("ckpt.resume", segment=int(meta["next_segment"]),
                         finished=bool(meta.get("finished")))
    net = payload.get("net") or {}
    fault = None
    if "fault" in net:
        saved = net["fault"]
        fault = resil.FaultState(
            saved["down"], None if "init" not in saved
            else carry.fault.init._replace(**saved["init"]))
    topo = payload.get("topo") or {}
    carry = EngineCarry(
        carry.state._replace(**fields),
        netsim.ChannelState(net["chan"]) if "chan" in net else None,
        netsim.GossipState(**net["gossip"]) if "gossip" in net else None,
        fault, topo_mod.TopoState(**topo) if topo else None)
    return (carry, int(meta["next_segment"]), bool(meta.get("finished")),
            n_frame_files)

# --------------------------------------------------------------------------
class LMFacade:
    """FACADE rounds on a language model, driven through ``facade_round``
    as ``examples/facade_lm_pretrain.py`` drives the reference's: the
    initial model and ``[k, ...]`` head bank from ``generator`` (default: a
    CPU generator seeded with ``seed``), every node's clustered token
    streams from ``make_clustered_tokens`` (sequences of ``seq + 1``
    tokens, ``seqs_per_node`` a node, nodes in clusters of ``clusters``),
    each round's ``[n, local_steps, batch]`` indices and topology from
    ``TorchDraws(seed)``. Rounds run with TF32 off, as ``run_experiment``.
    """

    def __init__(self, cfg, *, clusters, k: int, degree: int,
                 local_steps: int, batch: int, seq: int, lr: float,
                 head_jitter: float, seqs_per_node: int, seed: int = 0,
                 device="cuda", generator: torch.Generator | None = None):
        dev = device_mod.resolve(device)
        self.n, self.local_steps, self.batch = len(clusters), local_steps, \
            batch
        self.binding = make_binding(cfg)
        self.state = init_facade_state(
            self.binding, self.n, k, head_jitter=head_jitter, device=dev,
            generator=(generator if generator is not None
                       else torch.Generator().manual_seed(seed)))
        data = make_clustered_tokens(
            TokenSpec(vocab_size=cfg.vocab_size, seq_len=seq + 1,
                      seed=seed), clusters, seqs_per_node=seqs_per_node)
        self.train = torch.from_numpy(data["train"]).to(dev)
        self.draws = TorchDraws(seed)
        self.fcfg = facade_mod.FacadeConfig(n_nodes=self.n, k=k,
                                            degree=degree, lr=lr)

    def draw(self):
        """The next round's (batches, topology permutations)."""
        idx = self.draws.batch_indices(self.n, self.local_steps, self.batch,
                                       self.train.shape[1])
        batches = pipeline_mod.sample_round_token_batches(
            idx.to(self.train.device), self.train)
        perms = self.draws.perms(self.n, self.fcfg.degree)
        return batches, perms.to(self.train.device)

    def round(self, drawn=None) -> dict:
        """One round on ``drawn`` (default: :meth:`draw`); returns its info
        and keeps the new state on ``self.state``."""
        batches, perms = drawn if drawn is not None else self.draw()
        with device_mod.no_tf32():
            self.state, info = facade_mod.facade_round(
                self.fcfg, self.binding, self.state, batches, perms)
        return info
