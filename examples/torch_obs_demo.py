"""The fairness observatory on the PyTorch port, end to end: run FACADE
with full telemetry, read the per-eval DP/EO trajectory, check the
run-health verdict, and render the markdown run report.

    PYTHONPATH=src python examples/torch_obs_demo.py [--device cpu]

The port of ``examples/obs_demo.py``. Observation changes nothing of the
run: its trajectory is bit for bit what it is with ``obs=None``. Runs on
the NVIDIA card unless ``--device`` names another device; raises where
CUDA is missing.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.configs.facade_paper import lenet  # noqa: E402
from repro_torch.core.runner import TorchDraws, run_experiment  # noqa: E402
from repro_torch.data.synthetic import SynthSpec, make_clustered_data  # noqa: E402
from repro_torch.obs import Obs, ObsConfig  # noqa: E402
from repro_torch.obs.report import build_report  # noqa: E402


def run(*, cfg=None, out_dir=None, rounds: int = 24, k: int = 2,
        degree: int = 2, local_steps: int = 4, batch_size: int = 8,
        lr: float = 0.05, eval_every: int = 4, warmup_rounds: int = 4,
        seed: int = 0, device="cuda", draws=None) -> dict:
    """One observed FACADE run on the 6:2 dataset; returns ``{"result",
    "obs", "eval_table", "manifest", "manifest_path", "markdown"}``.
    ``out_dir`` (default: a new temporary directory) receives the JSONL
    trace and the manifest; ``draws`` is a callable of the seed giving the
    run's draws source (default ``TorchDraws``)."""
    device_mod.resolve(device)          # raise before making out_dir
    spec = SynthSpec(n_classes=4, image_size=16, samples_per_class=16,
                     test_per_class=32, seed=3)
    ds = make_clustered_data(spec, cluster_sizes=(6, 2),
                             transforms=("rot0", "rot180"))
    cfg = cfg if cfg is not None else lenet(smoke=True).replace(n_classes=4)
    draws = draws if draws is not None else TorchDraws
    out_dir = pathlib.Path(out_dir if out_dir is not None
                           else tempfile.mkdtemp(prefix="obs-demo-"))
    obs = Obs(ObsConfig(), jsonl=out_dir / "trace.jsonl", out_dir=out_dir)
    res = run_experiment("facade", cfg, ds, rounds=rounds, k=k,
                         degree=degree, local_steps=local_steps,
                         batch_size=batch_size, lr=lr, eval_every=eval_every,
                         warmup_rounds=warmup_rounds, seed=seed, obs=obs,
                         device=device, draws=draws(seed))
    last = res.eval_frames[-1]
    if not (last.dp == res.dp and last.eo == res.eo):
        raise AssertionError(f"the final dp/eo ({res.dp}, {res.eo}) are not "
                             f"the series' last entry {last}")
    manifest = obs.manifests[-1]
    manifest_path = out_dir / f"manifest_{manifest.name}.json"
    _, markdown = build_report(manifest_path)
    return {"result": res, "obs": obs, "eval_table": obs.eval_table(),
            "manifest": manifest, "manifest_path": manifest_path,
            "markdown": markdown}


def summary(out: dict) -> str:
    """The trajectory, the health verdict and its issues, the report and
    the command that renders it again."""
    table, health = out["eval_table"], out["manifest"].health
    lines = ["\nper-eval fairness trajectory (DP gap over training):"]
    for rnd, dp, eo, worst, churn in zip(
            table["round"], table["dp"], table["eo"],
            table["worst_cluster_acc"], table["cluster_churn"]):
        lines.append(f"  round {rnd:3d}: dp={dp:.3f} eo={eo:.3f} "
                     f"worst_cluster={worst:.3f} churn={churn:.0f}")
    lines.append(f"\nhealth verdict: {health['verdict']}")
    for issue in health["issues"]:
        lines.append(f"  {issue['rule']} [{issue['severity']}] rounds "
                     f"{issue['round_start']}-{issue['round_end']}: "
                     f"{issue['detail']}")
    if not health["issues"]:
        lines.append("  no issues — a clean run")
    lines += [f"\nrendered report ({out['manifest_path']}):\n",
              out["markdown"],
              "re-render any time with:\n"
              f"  PYTHONPATH=src python -m repro_torch.obs.report "
              f"{out['manifest_path']}"]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(summary(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
