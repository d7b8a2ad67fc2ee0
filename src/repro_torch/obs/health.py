"""Run health: a declarative rule engine over the telemetry streams.

The port of ``repro.obs.health`` (numpy only). Without it nothing
watches a run: a NaN-poisoned mixture, a quarantine storm, a cluster
assignment that never settles or an accuracy collapse all run to their
end and leave a results table that looks clean. The monitor judges the
two tables the drivers record, the per-round :class:`MetricsFrame` table
and the per-eval :class:`EvalFrame` table, against a few declarative
rules, on the host after the run: it never enters a captured graph,
forks no cache key and perturbs no trajectory.

Each rule is a pure function ``(HealthConfig, HealthContext, frames,
evals) -> [HealthIssue]`` registered under a name. Every issue carries a
severity and the round range it covers, fires a ``health.<rule>`` tracer
event, and rolls up into a :class:`HealthReport` whose verdict (``ok`` <
``warn`` < ``fail``) goes into the run's
:class:`~repro_torch.obs.sink.RunManifest` (``manifest.health``) and, per
cell, into ``run_sweep``'s JSON.

Adding a rule::

    @rule("my_rule")
    def _my_rule(cfg, ctx, frames, evals):
        rounds = frames["round"]
        if rounds.size == 0:          # stream not recorded: stay silent
            return []
        bad = frames["delivered_edges"] < 1
        return _mask_issues("my_rule", "warn", rounds, bad,
                            lambda grp: len(grp), "no edges delivered")

Rules tolerate empty tables (a run without a device ``ObsConfig`` has no
metrics frames; a ``target_acc`` run may stop after one eval) and take
their thresholds from :class:`HealthConfig`, so a deployment tunes or
``disable``s them without code changes. What only the driver knows (the
node count, the warmup length, the topology policy's inclusion floor,
whether faults were injected) comes in a :class:`HealthContext`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

SEVERITY_ORDER = {"ok": 0, "warn": 1, "fail": 2}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds for the built-in rules. Host-side only: never part of
    any cache key, changing it recompiles nothing."""
    norm_max: float = 1e6        # |update|/|param| beyond this = divergence
    quarantine_frac: float = 0.5  # (crashed+quarantined)/n spike threshold
    inclusion_slack: float = 0.05  # tolerated mean-inclusion shortfall
    #                                below the topo min_inclusion floor
    flap_frac: float = 0.25      # mean switches/n past warmup+grace = flap
    flap_grace: int = 8          # settling rounds granted after warmup
    stall_evals: int = 5         # window (in evals) for the stall test
    stall_tol: float = 1e-3      # improvement below this = stalled
    stall_acc: float = 0.5       # ...but only while accuracy is this low
    collapse_drop: float = 0.25  # absolute drop from the running peak
    collapse_min_peak: float = 0.4  # peaks below this never "collapse"
    disable: tuple = ()          # rule names to skip

    def __post_init__(self):
        unknown = set(self.disable) - set(RULES)
        if unknown:
            raise ValueError(
                f"disable names unknown health rules {sorted(unknown)}; "
                f"know {sorted(RULES)}")


@dataclasses.dataclass(frozen=True)
class HealthContext:
    """What the driver knows about the run that the tables don't say."""
    n: int                                # node count
    warmup_rounds: int = 0                # FACADE warmup length
    inclusion_floor: "float | None" = None  # topo min_inclusion when an
    #                                         adaptive policy guaranteed one
    faults: bool = False                  # fault injection was configured


@dataclasses.dataclass
class HealthIssue:
    """One rule firing over one round range."""
    rule: str
    severity: str        # "warn" | "fail"
    round_start: int
    round_end: int
    value: float         # the offending measurement (rule-specific)
    detail: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HealthReport:
    """Per-run rollup: the worst severity across every issue."""
    verdict: str         # "ok" | "warn" | "fail"
    issues: list         # [HealthIssue], sorted by round_start
    rounds_seen: int     # metrics frames examined
    evals_seen: int      # eval frames examined

    def to_json(self) -> dict:
        return {"verdict": self.verdict,
                "issues": [i.to_json() for i in self.issues],
                "rounds_seen": self.rounds_seen,
                "evals_seen": self.evals_seen}

    @classmethod
    def from_json(cls, data: dict) -> "HealthReport":
        return cls(verdict=data.get("verdict", "ok"),
                   issues=[HealthIssue(**i)
                           for i in data.get("issues", ())],
                   rounds_seen=int(data.get("rounds_seen", 0)),
                   evals_seen=int(data.get("evals_seen", 0)))


def worst_verdict(verdicts) -> str:
    """The most severe of a collection of verdict strings (unknown
    strings rank as ``fail`` — a garbled verdict is not a clean one)."""
    worst = "ok"
    for v in verdicts:
        rank = SEVERITY_ORDER.get(v, SEVERITY_ORDER["fail"])
        if rank > SEVERITY_ORDER[worst]:
            worst = v if v in SEVERITY_ORDER else "fail"
    return worst


# ---------------------------------------------------------------- rules --
RULES: "dict[str, Callable]" = {}


def rule(name: str):
    """Register a health rule under ``name`` (fires ``health.<name>``)."""
    def deco(fn):
        RULES[name] = fn
        return fn
    return deco


def _mask_issues(name, severity, rounds, mask, value_of, detail):
    """One :class:`HealthIssue` per CONTIGUOUS run of ``mask`` — rules
    report round ranges, not per-round spam."""
    issues = []
    idx = np.flatnonzero(np.asarray(mask))
    if idx.size == 0:
        return issues
    splits = np.split(idx, np.flatnonzero(np.diff(idx) > 1) + 1)
    for grp in splits:
        issues.append(HealthIssue(
            rule=name, severity=severity,
            round_start=int(rounds[grp[0]]), round_end=int(rounds[grp[-1]]),
            value=float(value_of(grp)), detail=detail))
    return issues


@rule("nonfinite")
def _nonfinite(cfg, ctx, frames, evals):
    """NaN/inf update or param norms: the model state itself is poisoned
    (e.g. unguarded NaN corruption, ``repro_torch.resil``)."""
    rounds = frames["round"]
    if rounds.size == 0:
        return []
    un, pn = frames["update_norm"], frames["param_norm"]
    bad = ~(np.isfinite(un) & np.isfinite(pn))
    return _mask_issues(
        "nonfinite", "fail", rounds, bad,
        lambda grp: np.sum(bad[grp]),
        "non-finite update/param norm: model state is poisoned")


@rule("divergence")
def _divergence(cfg, ctx, frames, evals):
    """Finite but runaway norms — the optimizer is blowing up."""
    rounds = frames["round"]
    if rounds.size == 0:
        return []
    un, pn = frames["update_norm"], frames["param_norm"]
    bad = (np.isfinite(un) & np.isfinite(pn)
           & ((un > cfg.norm_max) | (pn > cfg.norm_max)))
    return _mask_issues(
        "divergence", "fail", rounds, bad,
        lambda grp: max(np.max(un[grp]), np.max(pn[grp])),
        f"update/param norm exceeded norm_max={cfg.norm_max:g}")


@rule("quarantine_spike")
def _quarantine_spike(cfg, ctx, frames, evals):
    """Crash/quarantine mass above ``quarantine_frac`` of the nodes —
    the resilient path is carrying more faults than it was sized for."""
    rounds = frames["round"]
    if rounds.size == 0 or ctx.n <= 0:
        return []
    frac = (frames["crashed"] + frames["quarantined"]) / float(ctx.n)
    bad = frac > cfg.quarantine_frac
    return _mask_issues(
        "quarantine_spike", "warn", rounds, bad,
        lambda grp: np.max(frac[grp]),
        f"crashed+quarantined above {cfg.quarantine_frac:.0%} of nodes")


@rule("inclusion_floor")
def _inclusion_floor(cfg, ctx, frames, evals):
    """Mean inclusion below the topo ``min_inclusion`` guarantee (with
    ``inclusion_slack`` for per-round sampling noise) — the fairness
    floor the adaptive policy promised is not being delivered."""
    rounds = frames["round"]
    if rounds.size == 0 or ctx.inclusion_floor is None:
        return []
    tail = rounds > ctx.warmup_rounds
    if not np.any(tail):
        return []
    mean_inc = float(np.mean(frames["inclusion"][tail]))
    if mean_inc >= ctx.inclusion_floor - cfg.inclusion_slack:
        return []
    return [HealthIssue(
        rule="inclusion_floor", severity="warn",
        round_start=int(rounds[tail][0]), round_end=int(rounds[-1]),
        value=mean_inc,
        detail=(f"mean inclusion {mean_inc:.3f} below the topo floor "
                f"{ctx.inclusion_floor:.3f} (slack "
                f"{cfg.inclusion_slack:.3f})"))]


@rule("cluster_flapping")
def _cluster_flapping(cfg, ctx, frames, evals):
    """Cluster assignment still churning past warmup + grace — FACADE's
    settlement (paper Fig. 9) never happened."""
    rounds = frames["round"]
    if rounds.size == 0 or ctx.n <= 0:
        return []
    tail = rounds > ctx.warmup_rounds + cfg.flap_grace
    if not np.any(tail):
        return []
    mean_flap = float(np.mean(frames["cluster_switches"][tail])) / ctx.n
    if mean_flap <= cfg.flap_frac:
        return []
    return [HealthIssue(
        rule="cluster_flapping", severity="warn",
        round_start=int(rounds[tail][0]), round_end=int(rounds[-1]),
        value=mean_flap,
        detail=(f"mean cluster switches {mean_flap:.2f}/node/round past "
                f"warmup+{cfg.flap_grace} rounds (threshold "
                f"{cfg.flap_frac:.2f})"))]


@rule("accuracy_stall")
def _accuracy_stall(cfg, ctx, frames, evals):
    """No improvement over the last ``stall_evals`` evals while accuracy
    is still low — the run is burning rounds without learning."""
    rounds = evals["round"]
    if rounds.size < cfg.stall_evals:
        return []
    window = evals["mean_acc"][-cfg.stall_evals:]
    if not np.all(np.isfinite(window)):
        return []           # nonfinite rule owns poisoned runs
    improvement = float(window[-1] - window[0])
    if improvement >= cfg.stall_tol or window[-1] >= cfg.stall_acc:
        return []
    return [HealthIssue(
        rule="accuracy_stall", severity="warn",
        round_start=int(rounds[-cfg.stall_evals]), round_end=int(rounds[-1]),
        value=float(window[-1]),
        detail=(f"mean accuracy {window[-1]:.3f} improved "
                f"{improvement:+.4f} over the last {cfg.stall_evals} "
                f"evals (tol {cfg.stall_tol:g})"))]


@rule("accuracy_collapse")
def _accuracy_collapse(cfg, ctx, frames, evals):
    """Accuracy fell ``collapse_drop`` below its running peak — the run
    learned something and then lost it (divergence, poisoning, a bad
    restart)."""
    rounds = evals["round"]
    if rounds.size == 0:
        return []
    acc = np.where(np.isfinite(evals["mean_acc"]), evals["mean_acc"], 0.0)
    peak = np.maximum.accumulate(acc)
    bad = (peak >= cfg.collapse_min_peak) & (peak - acc >= cfg.collapse_drop)
    return _mask_issues(
        "accuracy_collapse", "fail", rounds, bad,
        lambda grp: np.max((peak - acc)[grp]),
        f"mean accuracy dropped >= {cfg.collapse_drop:g} below its peak")


# ------------------------------------------------------------- evaluate --
def evaluate(cfg: HealthConfig, ctx: HealthContext, frames: dict,
             evals: dict, tracer=None) -> HealthReport:
    """Run every (non-disabled) rule over the two tables, fire one
    ``health.<rule>`` tracer event per issue, and roll up the verdict.

    ``frames``: an ``Obs.frames_table()``-shaped dict (``round`` may be
    empty when no device ``ObsConfig`` was attached); ``evals``: an
    ``Obs.eval_table()``-shaped dict.
    """
    issues = []
    for name, fn in RULES.items():
        if name in cfg.disable:
            continue
        issues.extend(fn(cfg, ctx, frames, evals))
    issues.sort(key=lambda i: (i.round_start, i.rule))
    if tracer is not None:
        for i in issues:
            tracer.event(f"health.{i.rule}", severity=i.severity,
                         round_start=i.round_start, round_end=i.round_end,
                         value=i.value, detail=i.detail)
    return HealthReport(
        verdict=worst_verdict(i.severity for i in issues),
        issues=issues,
        rounds_seen=int(np.asarray(frames["round"]).size),
        evals_seen=int(np.asarray(evals["round"]).size))
