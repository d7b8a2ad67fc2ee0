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
the same run bit for bit. The seed-independent machinery (binding, round
closures, engine, evaluator) comes from an :class:`~.cache.EngineCache`
(``cache=``; a private one by default). The reference's pipelined driver,
checkpoint/resume, mesh, network simulation, adaptive topology and
telemetry are not ported yet, and ``run_experiment`` does not accept
their parameters.

Randomness comes from a *draws* source (:class:`TorchDraws` by default):
it supplies the initial parameters, each round's ``[n, H, B]`` batch
indices and each round's topology draw (FACADE and EL: the permutations
of a random regular graph; DAC: a Gumbel matrix; D-PSGD and DEPRL, on a
static ring: none), so a run can replay another's draws exactly.
``TorchDraws`` draws on the CPU and the runner moves the draws to the
run's device, so one seed gives the same draws on every device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.comm import CommLog
from repro_torch.data import pipeline
from repro_torch.data.tokens import TokenSpec, make_clustered_tokens
from repro_torch.obs import compute_eval_frame
from repro_torch.tree import tree_map

from . import facade as facade_mod
from . import split, topology
from .baselines import (DACConfig, DeprlConfig, DpsgdConfig, ELConfig,
                        dac_round, deprl_round, dpsgd_round, el_round,
                        init_dac_extra)
from .bindings import Binding, make_binding
from .cache import EngineCache, EngineSpec
from .engine import SegmentEngine, segment_plan
from .state import init_baseline_state, init_facade_state

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
    indices and one for topologies (permutations or Gumbel draws)."""

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
        return pipeline.draw_batch_indices(self._data, n, h, b, per_node)

    def perms(self, n: int, r: int):
        return topology.draw_perms(self._topo, n, r)

    def gumbel(self, n: int):
        """``[n, n]`` standard Gumbel draws, ``-log(-log(U))`` with U
        uniform in [tiny, 1)."""
        u = torch.rand((n, n), generator=self._topo).clamp_(
            min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))


# --------------------------------------------------------------------------
class AlgoProgram(NamedTuple):
    """The seed-independent part of an algorithm, behind one round
    signature: ``round_fn(state, batches, *topology) -> (state, info)``,
    where ``topology`` is the round's ``topology_draw`` (FACADE and EL:
    ``perms``, DAC: ``gumbel``, D-PSGD and DEPRL: none). ``EngineCache``
    memoizes programs per static configuration and mints each run's
    :class:`AlgoSetup` with :meth:`setup`. (The reference's
    ``mixable_of``, which its async-gossip buffers read, comes with
    netsim.)"""
    init_state: Callable       # (draws, device) -> initial stacked state
    round_fn: Callable         # main-phase round
    warmup_fn: Callable        # warmup-phase round (== round_fn off-FACADE)
    models_of: Callable        # state -> deployable models, stacked [n, ...]
    finalize: Callable         # applied to the state after the last round
    track_cluster: bool        # info carries a per-round cluster_id [n]
    topology_draw: str | None  # "perms" | "gumbel" | None

    def setup(self, draws, device) -> "AlgoSetup":
        return AlgoSetup(self, self.init_state(draws, device))


class AlgoSetup(NamedTuple):
    """One run: its algorithm's program and the initial stacked state,
    minted from the run's draws."""
    program: AlgoProgram
    state: Any


def algo_program(algo: str, binding: Binding, n: int, k: int, *,
                 degree: int, lr: float,
                 head_jitter: float = 0.0) -> AlgoProgram:
    """The program of ``algo`` (one of :data:`ALGOS`) on ``binding``'s
    model, ``n`` nodes, ``k`` FACADE heads."""
    if algo == "facade":
        fcfg = facade_mod.FacadeConfig(n_nodes=n, k=k, degree=degree, lr=lr)

        def init_state(draws, device):
            params, heads_k = draws.facade_init(binding, k, head_jitter)
            return init_facade_state(binding, n, k, params=params,
                                     heads_k=heads_k, device=device)

        return AlgoProgram(
            init_state=init_state,
            round_fn=functools.partial(facade_mod.facade_round, fcfg,
                                       binding, warmup=False),
            warmup_fn=functools.partial(facade_mod.facade_round, fcfg,
                                        binding, warmup=True),
            models_of=facade_mod.node_models,
            finalize=functools.partial(facade_mod.final_allreduce, fcfg),
            track_cluster=True, topology_draw="perms")
    if algo in BASELINES:
        cfg_cls, round_fn, topology_draw = BASELINES[algo]
        fn = functools.partial(
            round_fn, cfg_cls(n_nodes=n, degree=degree, lr=lr), binding)

        def init_state(draws, device):
            return init_baseline_state(
                binding, n, params=draws.baseline_init(binding),
                extra=init_dac_extra(n) if algo == "dac" else None,
                device=device)

        return AlgoProgram(
            init_state=init_state, round_fn=fn, warmup_fn=fn,
            models_of=lambda s: s.params, finalize=lambda s: s,
            track_cluster=False, topology_draw=topology_draw)
    raise ValueError(f"algorithm {algo!r} is not ported yet; the port "
                     f"runs {ALGOS}")


def algo_setup(algo: str, binding: Binding, draws, n: int, k: int, *,
               degree: int, lr: float, head_jitter: float = 0.0,
               device="cuda") -> AlgoSetup:
    """One run's :class:`AlgoSetup`, its initial state from ``draws``."""
    return algo_program(algo, binding, n, k, degree=degree, lr=lr,
                        head_jitter=head_jitter).setup(
        draws, device_mod.resolve(device))


# --------------------------------------------------------------------------
def make_evaluator(binding: Binding, node_cluster, test_x, test_y,
                   batch: int = 256, device="cuda") -> Callable:
    """Per-cluster evaluator: every node of a cluster runs the cluster's
    whole test set (zero-padded, masked eval batches), all of the cluster's
    nodes in one node-stacked forward per batch.

    Returns ``evaluate(models) -> (acc_per_cluster, preds_c, labels_c,
    node_acc)``: per-cluster mean node accuracy, the first node's
    predictions per cluster (for DP/EO), the labels, and the per-node
    accuracy ``[n]``. Clusters with no node are skipped;
    ``evaluate.cluster_ids`` says which cluster each entry is.
    """
    dev = device_mod.resolve(device)
    node_cluster = np.asarray(node_cluster)
    clusters = []
    for c in range(len(test_x)):
        idx = np.where(node_cluster == c)[0]
        if idx.size == 0:
            continue        # empty cluster: nothing to evaluate
        x = np.asarray(test_x[c])
        xb, mask = pipeline.padded_eval_batches(
            x, min(batch, max(1, x.shape[0])))
        clusters.append((idx, torch.from_numpy(idx).to(dev),
                         torch.from_numpy(xb).to(dev),
                         mask.reshape(-1) > 0, np.asarray(test_y[c])))

    @torch.no_grad()
    def predict(models_c, m: int, xb):               # xb [nb, B, ...]
        preds = [binding.forward(models_c, x.expand((m,) + x.shape))
                 .argmax(-1) for x in xb]
        return torch.stack(preds).cpu().numpy()      # [nb, m, B]

    def evaluate(models):
        accs, preds_c, labels_c = [], [], []
        node_acc = np.zeros(node_cluster.shape[0], np.float64)
        for idx, idx_t, xb, valid, y in clusters:
            p = predict(tree_map(lambda l: l[idx_t], models), len(idx), xb)
            p = np.moveaxis(p, 1, 0).reshape(len(idx), -1)[:, valid]
            eq = p == y[None, :]
            accs.append(float(eq.mean()))
            node_acc[idx] = eq.mean(axis=1)
            preds_c.append(p[0])
            labels_c.append(y)
        return accs, preds_c, labels_c, node_acc

    evaluate.cluster_ids = tuple(int(node_cluster[c[0][0]])
                                 for c in clusters)
    return evaluate


# --------------------------------------------------------------------------
class _History:
    """Bookkeeping of one run: comm log, eval histories, weighted mean
    accuracy and the target-accuracy stop condition."""

    def __init__(self, node_cluster, n: int, evaluator, models_of,
                 target_acc, verbose: bool, algo: str, n_classes: int):
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

    def eval_round(self, state, rnd: int, round_bytes: float) -> bool:
        """Evaluate at round ``rnd`` (1-based), record, and report whether
        ``target_acc`` is reached (the run then stops)."""
        accs, preds_c, labels_c, node_acc = self._evaluator(
            self._models_of(state))
        cids = self._evaluator.cluster_ids
        self.accs = accs
        self.node_acc = node_acc
        self.acc_hist.append((rnd, accs))
        mean_acc = float(np.mean(
            [a * (self._weights == c).sum()
             for c, a in zip(cids, accs)]) * len(accs) / self._n)
        cid = getattr(state, "cluster_id", None)
        # a copy: under the engine the state's ids are a static buffer
        eval_cid = None if cid is None else cid.cpu().numpy().copy()
        frame = compute_eval_frame(
            rnd, accs, cids, preds_c, labels_c, node_acc, self._n_classes,
            mean_acc=mean_acc, prev_cid=self._prev_eval_cid, cid=eval_cid)
        self._prev_eval_cid = eval_cid
        self.eval_frames.append(frame)
        self.fair_hist.append((rnd, frame.fair_acc))
        self.dp = frame.dp
        self.eo = frame.eo
        self.comm.record(rnd, round_bytes, mean_acc)
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
                   engine: bool = True,
                   cache: EngineCache | None = None) -> RunResult:
    """Run one (algorithm, dataset) experiment end to end on ``device``.

    ``algo`` is one of :data:`ALGOS`. ``draws`` supplies the initial
    parameters, batch indices and topology draws (default
    ``TorchDraws(seed)``); it has the methods of :class:`TorchDraws`.

    ``engine``: ``True`` runs the segment engine (:mod:`.engine`: on CUDA
    each eval-to-eval span replays one captured round, with one host
    transfer a span); ``False`` the per-round loop. On one device both
    give the same run bit for bit.

    ``cache``: an :class:`EngineCache` shared across calls, so that the
    runs of one configuration capture their rounds and build their
    evaluator once; ``None`` uses a fresh private cache.

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
                    engine=engine, cache=cache)


def _run(algo: str, cfg, dataset, *, rounds: int, k, degree: int,
         local_steps: int, batch_size: int, lr: float, eval_every: int,
         seed: int, warmup_rounds: int, head_jitter: float, target_acc,
         eval_batch: int, verbose: bool, device, draws, engine: bool,
         cache) -> RunResult:
    if algo not in ALGOS:
        raise ValueError(f"algorithm {algo!r} is not ported yet; the port "
                         f"runs {ALGOS}")
    if eval_every <= 0:
        raise ValueError(
            f"eval_every={eval_every} must be a positive round count")
    if target_acc is not None and eval_every > rounds:
        raise ValueError(
            f"target_acc={target_acc} can never trigger an early exit with "
            f"eval_every={eval_every} > rounds={rounds}")
    n = dataset.n_nodes
    if not 1 <= degree < n:
        raise ValueError(f"degree={degree} out of range for n={n} nodes: "
                         "pick 1 <= degree <= n - 1")
    if algo != "facade":
        warmup_rounds = 0       # only FACADE has a warmup phase; keeps the
        #                         baselines' cache keys from forking
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    k = k if k is not None else dataset.k
    draws = draws if draws is not None else TorchDraws(seed)
    cache = cache if cache is not None else EngineCache()
    spec = EngineSpec(algo=algo, cfg=cfg, n=n, k=k, degree=degree,
                      local_steps=local_steps, batch_size=batch_size, lr=lr,
                      warmup_rounds=warmup_rounds, head_jitter=head_jitter,
                      eval_batch=eval_batch, device=dev)
    entry = cache.entry(spec)
    # pinned while the run is live: an LRU-bounded cache must never evict
    # the engine whose static buffers the run is using
    with cache.pin(spec):
        setup = entry.setup(draws)
        models_of = setup.program.models_of
        evaluator = cache.evaluator(entry.binding, dataset,
                                    batch=eval_batch, device=dev)
        hist = _History(dataset.node_cluster, n, evaluator, models_of,
                        target_acc, verbose, algo, cfg.n_classes)
        if engine:
            train_x, train_y = entry.engine.place_data(dataset)
            state = _drive_engine(entry.engine, setup, hist, draws, train_x,
                                  train_y, rounds=rounds,
                                  eval_every=eval_every,
                                  warmup_rounds=warmup_rounds)
            # the state's tensors are the engine's static buffers, which a
            # later run of this entry overwrites: the result keeps copies
            models = tree_map(torch.clone, models_of(state))
        else:
            train_x, train_y = pipeline.place(dataset, dev)
            state = _drive_loop(setup, hist, draws, train_x, train_y,
                                rounds=rounds, eval_every=eval_every,
                                warmup_rounds=warmup_rounds,
                                local_steps=local_steps,
                                batch_size=batch_size, n=n, degree=degree)
            models = models_of(state)
    return hist.result(algo, models)


def _drive_loop(setup: AlgoSetup, hist: _History, draws, train_x, train_y,
                *, rounds, eval_every, warmup_rounds, local_steps,
                batch_size, n, degree):
    """The per-round loop: every round drawn, run and recorded on its own.
    Returns the final state."""
    program, state = setup
    dev = train_x.device
    per_node = train_x.shape[1]

    def draw_topology() -> tuple:
        """The round's topology draw, which follows the algorithm (the
        reference splits its key only for a round that uses it)."""
        if program.topology_draw == "perms":
            return (draws.perms(n, degree).to(dev),)
        if program.topology_draw == "gumbel":
            return (draws.gumbel(n).to(dev),)
        return ()

    for rnd in range(rounds):
        idx = draws.batch_indices(n, local_steps, batch_size, per_node)
        batches = pipeline.sample_round_batches(idx.to(dev), train_x,
                                                train_y)
        fn = program.warmup_fn if rnd < warmup_rounds else program.round_fn
        state, info = fn(state, batches, *draw_topology())
        last_round = rnd == rounds - 1
        if last_round:
            state = program.finalize(state)
        if (rnd + 1) % eval_every == 0 or last_round:
            if hist.eval_round(state, rnd + 1, info["round_bytes"]):
                break
        else:
            hist.comm.record(rnd + 1, info["round_bytes"])
        if program.track_cluster:
            hist.cluster_hist.append((rnd + 1, state.cluster_id))
    return state


def _drive_engine(eng: SegmentEngine, setup: AlgoSetup, hist: _History,
                  draws, train_x, train_y, *, rounds, eval_every,
                  warmup_rounds):
    """Segment-engine driver: one dispatch and one host transfer per span
    (the reference's serialized ``_drive_engine``). A ``target_acc`` hit
    stops at the eval that reaches it, and the cluster history then ends
    a round earlier, as the loop, which breaks before appending the eval
    round's ids. Returns the final state (its tensors are ``eng``'s static
    buffers, finalized ones after the last round)."""
    program, state = setup
    carry = eng.init_carry(state)
    for seg in segment_plan(rounds, eval_every, warmup_rounds):
        carry, outs = eng.run_segment(carry, seg.start, seg.length,
                                      train_x, train_y, draws,
                                      warmup=seg.warmup)
        rnds = np.arange(seg.start + 1, seg.start + seg.length + 1)
        hit = False
        if seg.eval_at_end:
            hist.comm.record_bulk(rnds[:-1], outs["round_bytes"][:-1])
            if seg.start + seg.length == rounds:
                carry = carry._replace(state=program.finalize(carry.state))
            hit = hist.eval_round(carry.state, int(rnds[-1]),
                                  float(outs["round_bytes"][-1]))
        else:
            hist.comm.record_bulk(rnds, outs["round_bytes"])
        if program.track_cluster:
            upto = len(rnds) - 1 if hit else len(rnds)
            hist.cluster_hist.extend(
                (int(rnds[i]), outs["cluster_id"][i]) for i in range(upto))
        if hit:
            break
    return carry.state


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
        batches = pipeline.sample_round_token_batches(
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
