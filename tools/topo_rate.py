#!/usr/bin/env python3
"""FACADE's steady engine rate under each adaptive topology policy, in
turns on one card.

    python3 tools/topo_rate.py [--reps 7] [--out FILE]

At paper scale on GN-LeNet (``chip_smoke.py``'s data and ``PAPER``
settings) on the reference benchmark's comm-bound ``core-edge``
(``compute_s_per_step=0.002``), with no policy, ``chip_smoke.TOPO_REL``
and ``chip_smoke.TOPO_BW``: one ``EngineCache`` a policy, whose seed-0
run captures; then ``--reps`` rounds of timed seed-1 runs of
``NET_RATE_ROUNDS`` rounds (``chip_smoke.timed_run``: host clock between
two synchronises), the policies in turns, the order reversed every other
round. Also times the host's topology draws of such a run (the
permutations without a policy, a ``TopoDraw`` a round with one). Prints
the card's name and power limit, then one JSON object: every run's
rounds per second, and per policy the median, the quartiles and the
median's ratio to no policy's (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.cache import EngineCache  # noqa: E402
from repro_torch.core.runner import TorchDraws, run_experiment  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.netsim import NetworkConfig  # noqa: E402


def draw_seconds(policy, n: int, rounds: int) -> float:
    """Host seconds of ``rounds`` rounds of FACADE's topology draws."""
    draws = TorchDraws(1)
    t0 = time.perf_counter()
    for _ in range(rounds):
        if policy is None:
            draws.perms(n, cs.PAPER["degree"])
        else:
            draws.policy_draw(n)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("topo_rate: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    build.build("head_select")
    ds = cs.paper_lenet_data({})
    cfg = cs.lenet()
    net = NetworkConfig.preset("core-edge", compute_s_per_step=0.002)
    kw = dict(cs.PAPER, rounds=cs.NET_RATE_ROUNDS,
              eval_every=cs.NET_RATE_ROUNDS, net=net)
    policies = {"none": None, "reliability": cs.TOPO_REL,
                "bandwidth": cs.TOPO_BW}
    caches = {}
    for name, topo in policies.items():
        caches[name] = EngineCache()
        run_experiment("facade", cfg, ds, cache=caches[name], device="cuda",
                       topo=topo, **kw)
    runs = []
    for rep in range(args.reps):
        order = list(policies) if rep % 2 == 0 else list(policies)[::-1]
        for name in order:
            res, wall, _, _ = cs.timed_run(
                "facade", cfg, ds, cache=caches[name], topo=policies[name],
                **dict(kw, seed=1))
            runs.append({"policy": name, "rep": rep,
                         "rounds_per_s": cs.NET_RATE_ROUNDS / wall,
                         "sim_seconds": res.comm.seconds[-1]})
            print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for name, topo in policies.items():
        rates = [r["rounds_per_s"] for r in runs if r["policy"] == name]
        q1, med, q3 = np.percentile(rates, [25, 50, 75])
        summary[name] = {
            "median": med, "q1": q1, "q3": q3, "min": min(rates),
            "max": max(rates),
            "draw_s_per_run": draw_seconds(topo, ds.n_nodes,
                                           cs.NET_RATE_ROUNDS)}
    for got in summary.values():
        got["median_vs_none"] = got["median"] / summary["none"]["median"]
    text = json.dumps({"runs": runs, "summary": summary}, indent=1)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
