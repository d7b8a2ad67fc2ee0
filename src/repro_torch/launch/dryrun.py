"""Single-card dry run: trace every (arch × input-shape) step on fake
tensors at its full size and write its roofline terms, without a card
(the counterpart of ``repro.launch.dryrun``).

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all              # 10 × 4 cases
    python -m repro_torch.launch.dryrun --facade ARCH      # FACADE's step

Each case builds its step with ``launch.steps`` on ``FakeTensorMode``
tensors on the CPU (shapes only: nothing is allocated, so any batch
traces), runs it once under ``roofline.count_step`` and prints one JSON
line, appended to ``results/dryrun/*.jsonl``: the reference's keys, with
``mesh`` ``"h100x1"``, ``chips`` 1 and ``t_trace_s`` (building and
tracing the step) in place of ``t_lower_s``/``t_compile_s``; ``status``
``ok``, ``skipped`` (the ``LONG_CTX_SKIP`` pairs at ``long_500k``, with
the reason) or ``fail`` (with the error). On CPU tensors the kernels'
wrappers run their plain versions, which compute the same function: the
plain attention counts every one of the S² scores, where K2 on the card
skips the masked tiles (``roofline/analysis.py`` states the convention).
The dry run makes no claim about a device: its terms divide the counts by
the H100's data-sheet peaks (``launch.mesh.HW``). Tokens are counted as
the reference counts them (B·S, a decode B; FACADE's n·B·S).

The reference's mesh flags (``--multi-pod``, ``--no-fsdp``, ``--unroll``,
``--no-act-sharding``, ``--seq-model``) have no single-card meaning and
are not accepted.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys
import time
import traceback

import torch

from repro_torch import configs as _configs  # noqa: F401  (registry)
from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch import steps
from repro_torch.launch.mesh import HW, MESH_NAME
from repro_torch.models.base import list_archs
from repro_torch.roofline import analyze_step, count_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun"


# --------------------------------------------------------------------------
def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _paths(sub, f"{prefix}/{key}" if prefix else key)
    else:
        yield prefix, tree


def active_param_count(cfg, params) -> int:
    """Params touched per token: MoE expert stacks count at
    experts_per_token / n_experts of their size."""
    total = 0
    for ps, leaf in _paths(params):
        size = int(leaf.numel())
        if cfg.n_experts and re.search(r"moe/w_(gate|up|down)", ps):
            frac = cfg.experts_per_token / cfg.n_experts
            size = int(size * frac)
        total += size
    return total


def _report(case, cost, n_tokens: int, kind: str, n_params: int) -> dict:
    return analyze_step(
        cost, arch=case.arch, shape=case.shape, mesh_name=MESH_NAME,
        chips=1, hw=HW, n_params_active=n_params, n_tokens=n_tokens,
        kind=kind).row()


def run_case(arch: str, shape: str, *, remat: bool = True,
             tag: str = "") -> dict:
    rec = {"arch": arch, "shape": shape, "mesh": MESH_NAME, "chips": 1,
           "tag": tag, "status": "?"}
    t0 = time.time()
    try:
        if not steps.is_supported(arch, shape):
            rec["status"] = "skipped"
            rec["reason"] = "full-attention arch; no 500k decode variant"
            return rec
        case = steps.build_case(arch, shape, remat=remat, abstract=True)
        cost = count_step(case.step_fn, case.args, case.context)
        shp = INPUT_SHAPES[shape]
        n_tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode"
                                       else 1)
        rec.update(_report(case, cost, n_tokens, shp.kind,
                           active_param_count(case.cfg, case.args[0])))
        rec.update(status="ok", t_trace_s=round(time.time() - t0, 1))
    except Exception as e:  # a failure here is a bug of the port: record it
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def run_facade_case(arch: str, *, remat: bool = True, tag: str = "facade"
                    ) -> dict:
    """The paper's technique: 2 FACADE nodes, each a whole model, one
    round (``steps.build_facade_case``)."""
    rec = {"arch": arch, "shape": "facade_pod", "mesh": MESH_NAME,
           "chips": 1, "status": "?", "tag": tag}
    t0 = time.time()
    try:
        case = steps.build_facade_case(arch, remat=remat, abstract=True)
        cost = count_step(case.step_fn, case.args, case.context)
        rec.update(_report(case, cost, case.n_tokens, "train",
                           active_param_count(case.cfg,
                                              case.args[0].cores)))
        rec.update(status="ok", t_trace_s=round(time.time() - t0, 1))
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--facade", metavar="ARCH", default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="jsonl output path")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out) if args.out else (
        RESULTS / f"dryrun_{MESH_NAME}"
        f"{('_' + args.tag) if args.tag else ''}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)

    if args.facade:
        cases = [("facade", args.facade, None)]
    elif args.all:
        cases = [("case", a, s) for a in list_archs() for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        cases = [("case", args.arch, args.shape)]
    else:
        ap.error("need --arch + --shape, --all, or --facade ARCH")
    recs = []
    for what, a, s in cases:
        if what == "facade":
            rec = run_facade_case(a, remat=not args.no_remat,
                                  tag=args.tag or "facade")
        else:
            rec = run_case(a, s, remat=not args.no_remat, tag=args.tag)
        recs.append(rec)
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "traceback"}), flush=True)

    with out.open("a") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    n_fail = sum(r["status"] == "fail" for r in recs)
    print(f"# {len(recs)} cases, {n_fail} failures -> {out}", file=sys.stderr)
    return 1 if n_fail else 0


if __name__ == "__main__":
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    sys.exit(main())
