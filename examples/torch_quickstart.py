"""Quickstart on the PyTorch port: train FACADE on a small clustered
dataset and watch the minority cluster get fair treatment.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of ``examples/quickstart.py``: a 6:2 imbalanced two-cluster
network (images of the minority cluster rotated 180 deg) where Epidemic
Learning under-serves the minority and FACADE closes the gap at the same
per-round communication cost. Runs on the NVIDIA card unless ``--device``
names another device; raises where CUDA is missing.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.facade_paper import lenet  # noqa: E402
from repro_torch.core.runner import TorchDraws, run_experiment  # noqa: E402
from repro_torch.data.synthetic import SynthSpec, make_clustered_data  # noqa: E402


def run(*, cfg=None, cluster_sizes=(6, 2), rounds: int = 48, k: int = 2,
        degree: int = 2, local_steps: int = 4, batch_size: int = 8,
        lr: float = 0.05, eval_every: int = 12,
        seed: int = 0, head_jitter: float = 0.0, verbose: bool = True,
        device="cuda", draws=None) -> dict:
    """EL and FACADE on a clustered dataset (paper Sec. V-A: 4 classes of
    16x16 images, the minority cluster rotated 180 deg); returns
    ``{"dataset": ds, "el": RunResult, "facade": RunResult}``. ``cfg``
    defaults to the smoke LeNet with 4 classes; ``draws`` is a callable
    of the seed giving each run's draws source (default
    ``TorchDraws``)."""
    spec = SynthSpec(n_classes=4, image_size=16, samples_per_class=16,
                     test_per_class=32, seed=3)
    ds = make_clustered_data(spec, cluster_sizes=cluster_sizes,
                             transforms=("rot0", "rot180"))
    cfg = cfg if cfg is not None else lenet(smoke=True).replace(n_classes=4)
    draws = draws if draws is not None else TorchDraws
    if verbose:
        print("nodes:", ds.n_nodes, " clusters:", ds.k,
              " node->cluster:", ds.node_cluster.tolist())
    out = {"dataset": ds}
    for algo in ("el", "facade"):
        if verbose:
            print(f"\n=== {algo.upper()} ===")
        out[algo] = run_experiment(
            algo, cfg, ds, rounds=rounds, k=k, degree=degree,
            local_steps=local_steps, batch_size=batch_size, lr=lr,
            eval_every=eval_every, seed=seed, head_jitter=head_jitter,
            verbose=verbose, device=device, draws=draws(seed))
    return out


def summary(out: dict) -> str:
    """The reference's summary table, bytes line and head choices."""
    el, facade = out["el"], out["facade"]
    return "\n".join([
        "\n================= summary =================",
        f"{'':18s}{'majority':>10s}{'minority':>10s}{'fair_acc':>10s}",
        f"{'EL':18s}{el.final_acc[0]:10.3f}{el.final_acc[1]:10.3f}"
        f"{el.best_fair_acc():10.3f}",
        f"{'FACADE':18s}{facade.final_acc[0]:10.3f}"
        f"{facade.final_acc[1]:10.3f}{facade.best_fair_acc():10.3f}",
        f"\nper-round bytes  EL: {el.comm.bytes[0]:.0f}   "
        f"FACADE: {facade.comm.bytes[0]:.0f}  (same cost, Sec. V-E)",
        f"final head choice per node: "
        f"{facade.cluster_history[-1][1].tolist()}"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(summary(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
