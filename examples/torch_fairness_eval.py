"""Fairness audit of trained DL models on the PyTorch port (paper Sec.
V-C/V-D).

    PYTHONPATH=src python examples/torch_fairness_eval.py [--device cpu]

The port of ``examples/fairness_eval.py``: trains FACADE and EL briefly
on a 7:1 clustered dataset, then reports the fairness panel: per-cluster
accuracy, fair accuracy (Eq. 5, sweeping lambda), demographic parity
(Eq. 1) and equalized odds (Eq. 2). Runs on the NVIDIA card unless
``--device`` names another device; raises where CUDA is missing.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.facade_paper import lenet  # noqa: E402
from repro_torch.core.runner import TorchDraws, run_experiment  # noqa: E402
from repro_torch.data.synthetic import SynthSpec, make_clustered_data  # noqa: E402
from repro_torch.fairness.metrics import fair_accuracy  # noqa: E402

LAMBDAS = (0.5, 2 / 3, 0.9)


def run(*, cfg=None, cluster_sizes=(7, 1), rounds: int = 48, k: int = 2,
        degree: int = 2, local_steps: int = 4, batch_size: int = 8,
        lr: float = 0.05, eval_every: int = 12, seed: int = 0,
        device="cuda", draws=None) -> dict:
    """EL and FACADE on the 7:1 dataset; returns ``{"el": RunResult,
    "facade": RunResult, "fair_acc": {algo: [fair accuracy at each of
    LAMBDAS]}}``. ``draws`` is a callable of the seed giving each run's
    draws source (default ``TorchDraws``)."""
    spec = SynthSpec(n_classes=4, image_size=16, samples_per_class=16,
                     test_per_class=32, seed=3)
    ds = make_clustered_data(spec, cluster_sizes, ("rot0", "rot180"))
    cfg = cfg if cfg is not None else lenet(smoke=True).replace(n_classes=4)
    draws = draws if draws is not None else TorchDraws
    out = {}
    for algo in ("el", "facade"):
        out[algo] = run_experiment(
            algo, cfg, ds, rounds=rounds, k=k, degree=degree,
            local_steps=local_steps, batch_size=batch_size, lr=lr,
            eval_every=eval_every, seed=seed, device=device,
            draws=draws(seed))
    out["fair_acc"] = {algo: [fair_accuracy(out[algo].final_acc, lam=lam)
                              for lam in LAMBDAS]
                       for algo in ("el", "facade")}
    return out


def summary(out: dict) -> str:
    """The reference's panel and gap lines."""
    el, fa = out["el"], out["facade"]
    lines = [
        f"{'metric':34s}{'EL':>10s}{'FACADE':>10s}",
        f"{'accuracy majority cluster':34s}{el.final_acc[0]:10.3f}"
        f"{fa.final_acc[0]:10.3f}",
        f"{'accuracy minority cluster':34s}{el.final_acc[1]:10.3f}"
        f"{fa.final_acc[1]:10.3f}",
        f"{'demographic parity (dn)':34s}{el.dp:10.4f}{fa.dp:10.4f}",
        f"{'equalized odds (dn)':34s}{el.eo:10.4f}{fa.eo:10.4f}"]
    for lam, fe, ff in zip(LAMBDAS, out["fair_acc"]["el"],
                           out["fair_acc"]["facade"]):
        lines.append(f"fair accuracy (lambda={lam:.2f}){'':11s}{fe:10.3f}"
                     f"{ff:10.3f}")
    gap_el = el.final_acc[0] - el.final_acc[1]
    gap_fa = fa.final_acc[0] - fa.final_acc[1]
    lines.append(f"\ncluster accuracy gap: EL {gap_el:+.3f}  "
                 f"FACADE {gap_fa:+.3f}")
    if gap_fa < gap_el:
        lines.append("FACADE reduces the majority/minority gap "
                     "(the paper's Fig. 3 finding).")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(summary(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
