"""netsim demo on the PyTorch port: the same FACADE experiment on an ideal
network, on flaky edge devices, through a scheduled partition-then-heal
scenario, and under bursty links, a core/edge link fabric and
asynchronous stale gossip.

    PYTHONPATH=src python examples/torch_netsim_demo.py [--device cpu]

The port of ``examples/netsim_demo.py``, in three parts:

1. seven scenarios: five presets, the netsim-v2 presets' union
   (``edge-v2``) and a scripted bad day on ``wan`` (a third of the fleet
   down at round 12 for 6 rounds, then two camps for rounds 24-32), each
   with its accuracy, the bytes delivered and the simulated hours;
2. an adaptive topology policy (``repro_torch.topo``, per-link goodput
   EWMAs with a ``min_inclusion`` fairness floor) against the blind
   uniform sampler on ``edge-v2``;
3. hostile nodes (``repro_torch.resil``): a quarter of the fleet
   publishes NaN-poisoned models every round on ``edge-v2``, with the
   robust gossip guard on and off, and the per-tier accuracy of each.

Runs on the NVIDIA card unless ``--device`` names another device; raises
where CUDA is missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.facade_paper import lenet  # noqa: E402
from repro_torch.core.runner import TorchDraws, run_experiment  # noqa: E402
from repro_torch.data.synthetic import SynthSpec, make_clustered_data  # noqa: E402
from repro_torch.netsim import BurstFailure, NetworkConfig, Partition  # noqa: E402
from repro_torch.obs import tiers_of  # noqa: E402
from repro_torch.resil import FaultConfig  # noqa: E402
from repro_torch.topo import TopoConfig  # noqa: E402


def scenarios() -> dict:
    """The seven networks of the first part, by name."""
    bad_day = NetworkConfig.preset(
        "wan", events=(BurstFailure(start=12, duration=6, fraction=0.33),
                       Partition(start=24, duration=8, groups=2)))
    return {"ideal": NetworkConfig.preset("ideal"),
            "edge-churn": NetworkConfig.preset("edge-churn"),
            "wan+events": bad_day,
            "bursty-wan": NetworkConfig.preset("bursty-wan"),
            "core-edge": NetworkConfig.preset("core-edge"),
            "async-edge": NetworkConfig.preset("async-edge"),
            "edge-v2": NetworkConfig.preset("edge-v2")}


def run(*, cfg=None, rounds: int = 48, k: int = 2, degree: int = 2,
        local_steps: int = 4, batch_size: int = 8, lr: float = 0.05,
        eval_every: int = 12, seed: int = 0, device="cuda",
        draws=None) -> dict:
    """Every run of the demo; returns ``{"scenarios": {name: RunResult},
    "uniform": RunResult, "reliability": RunResult, "hostile": {label:
    (RunResult, tiers)}}``, ``tiers`` the run's own node tiers (0 core, 1
    edge) from its draws source. ``draws`` is a callable of the seed
    giving each run's draws source (default ``TorchDraws``)."""
    spec = SynthSpec(n_classes=4, image_size=16, samples_per_class=16,
                     test_per_class=32, seed=3)
    ds = make_clustered_data(spec, cluster_sizes=(6, 2),
                             transforms=("rot0", "rot180"))
    cfg = cfg if cfg is not None else lenet(smoke=True).replace(n_classes=4)
    draws = draws if draws is not None else TorchDraws
    kw = dict(rounds=rounds, k=k, degree=degree, local_steps=local_steps,
              batch_size=batch_size, lr=lr, eval_every=eval_every, seed=seed,
              device=device)

    def facade(net, topo=None, source=None):
        return run_experiment("facade", cfg, ds, net=net, topo=topo,
                              draws=source if source is not None
                              else draws(seed), **kw)

    out = {"scenarios": {name: facade(net)
                         for name, net in scenarios().items()}}
    edge_v2 = NetworkConfig.preset("edge-v2")
    out["uniform"] = facade(edge_v2)
    out["reliability"] = facade(edge_v2, TopoConfig(
        policy="reliability", min_inclusion=0.25, decay=0.7))
    out["hostile"] = {}
    for label, robust in (("robust", True), ("unguarded", False)):
        net = dataclasses.replace(edge_v2, faults=FaultConfig(
            corrupt_rate=0.25, corrupt_mode="nan", robust=robust))
        source = draws(seed)
        res = facade(net, source=source)
        out["hostile"][label] = (res, tiers_of(net, ds.n_nodes, source))
    return out


def summary(out: dict) -> str:
    """The reference's three tables."""
    lines = [f"{'scenario':<12} {'majority':>9} {'minority':>9} "
             f"{'fair_acc':>9} {'traffic':>10} {'sim time':>9}"]
    for name, res in out["scenarios"].items():
        lines += [f"{name:<12} {res.final_acc[0]:>9.3f} "
                  f"{res.final_acc[1]:>9.3f} {res.best_fair_acc():>9.3f} "
                  f"{res.comm.bytes[-1]/1e6:>7.1f} MB "
                  f"{res.comm.seconds[-1]/3600:>7.2f} h",
                  f"{'':<12} final cluster choice per node: "
                  f"{res.cluster_history[-1][1].tolist()}"]
    uni, ada = out["uniform"], out["reliability"]
    d_bytes = 1.0 - ada.comm.bytes[-1] / uni.comm.bytes[-1]
    d_hours = 1.0 - ada.comm.seconds[-1] / uni.comm.seconds[-1]
    lines += ["\nadaptive vs uniform topology on edge-v2 "
              "(reliability policy, min_inclusion=0.25):"]
    for label, res in (("uniform", uni), ("reliability", ada)):
        lines.append(f"{label:<12} {res.comm.bytes[-1]/1e6:7.1f} MB "
                     f"{res.comm.seconds[-1]/3600:7.2f} h "
                     f"fair_acc {res.best_fair_acc():.3f}")
    lines += [f"{'':<12} delta: {100*d_bytes:.1f}% fewer bytes, "
              f"{100*d_hours:.1f}% fewer simulated hours",
              "\nhostile nodes on edge-v2 (25% NaN corruption), robust "
              "guard on vs off:",
              f"{'guard':<12} {'fair_acc':>9} {'core tier':>10} "
              f"{'edge tier':>10} {'finite':>7}"]
    for label, (res, tiers) in out["hostile"].items():
        acc = np.asarray(res.node_acc, float)
        finite = bool(np.all(np.isfinite(acc)))
        lines.append(f"{label:<12} {res.best_fair_acc():>9.3f} "
                     f"{tier_mean(acc, tiers, 0):>10.3f} "
                     f"{tier_mean(acc, tiers, 1):>10.3f} "
                     f"{'yes' if finite else 'NO':>7}")
    return "\n".join(lines)


def tier_mean(acc, tiers, tier: int) -> float:
    """Mean accuracy of the nodes of ``tier`` (NaN where it has none)."""
    sel = acc[np.asarray(tiers) == tier]
    return float(sel.mean()) if sel.size else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(summary(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
