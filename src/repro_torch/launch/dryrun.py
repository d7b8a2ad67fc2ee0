"""Dry run: trace every (arch × input-shape) step on fake tensors at its
full size and write its roofline terms, without a card (the counterpart
of ``repro.launch.dryrun``), on one card or on the reference's
production meshes.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all              # 10 × 4 cases
    python -m repro_torch.launch.dryrun --facade ARCH      # FACADE's step
    python -m repro_torch.launch.dryrun --all --mesh pod   # (16, 16)
    python -m repro_torch.launch.dryrun --all --mesh pod --multi-pod

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

``--mesh pod`` traces the same steps on ``make_production_mesh``'s
``(data 16, model 16)`` (``--multi-pod``: ``(pod 2, data 16, model 16)``)
inside a ``fake_world`` of 256 (512) ranks in this one process: the
arguments are DTensors laid out by ``launch.shardings`` and the step runs
under the reference's activation hooks (``launch.steps.build_case(mesh=
...)``). The records then have the reference's mesh names (``pod16x16``,
``pod2x16x16``), ``chips`` 256 or 512, and per-card terms: one rank's
FLOPs and bytes and the result bytes of the collectives it issues over
NVLink's rate (``roofline.count_step``). The reference's mesh flags apply
there: ``--no-fsdp``, ``--no-act-sharding`` and ``--seq-model`` /
``--no-seq-model`` (default on, as the reference's CLI). On one card
(``--mesh h100x1``, the default) they have no meaning and are refused, as
is ``--unroll`` everywhere (there is no scan to unroll).
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
from repro_torch.launch.mesh import (HW, MESH_NAME, PROD_MESH_NAMES,
                                     fake_world, make_production_mesh)
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


def _report(case, cost, n_tokens: int, kind: str, n_params: int,
            mesh_name: str = MESH_NAME, chips: int = 1) -> dict:
    return analyze_step(
        cost, arch=case.arch, shape=case.shape, mesh_name=mesh_name,
        chips=chips, hw=HW, n_params_active=n_params, n_tokens=n_tokens,
        kind=kind).row()


def _mesh_of(mesh: str, multi_pod: bool):
    """``(name, chips, world)``: the records' mesh label, its chips and
    the fake world it is traced in (None: one card)."""
    if mesh == MESH_NAME:
        return MESH_NAME, 1, None
    name = PROD_MESH_NAMES[multi_pod]
    chips = 512 if multi_pod else 256
    return name, chips, chips


def _in_world(world, multi_pod: bool, fn):
    """``fn(mesh)`` on the production mesh inside a fake world of
    ``world`` ranks (``fn(None)`` on one card)."""
    if world is None:
        return fn(None)
    with fake_world(world):
        return fn(make_production_mesh(multi_pod=multi_pod, device="cpu"))


def trace_case(arch: str, shape: str, mesh=None, **build_kw):
    """Build ``arch`` at ``shape`` on fake tensors (over ``mesh``, a
    ``DeviceMesh`` of the live process group, or on one card) and count
    one run of its step: -> (case, ``StepCost``)."""
    case = steps.build_case(arch, shape, abstract=True, mesh=mesh,
                            **build_kw)
    return case, count_step(case.step_fn, case.args, case.context)


def run_case(arch: str, shape: str, *, remat: bool = True, tag: str = "",
             mesh: str = MESH_NAME, multi_pod: bool = False,
             fsdp: bool = True, act_sharding: bool = True,
             seq_model: bool = True) -> dict:
    mesh_name, chips, world = _mesh_of(mesh, multi_pod)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
           "tag": tag, "status": "?"}
    t0 = time.time()
    try:
        if not steps.is_supported(arch, shape):
            rec["status"] = "skipped"
            rec["reason"] = "full-attention arch; no 500k decode variant"
            return rec
        kw = {} if world is None else dict(
            fsdp=fsdp, act_sharding=act_sharding, seq_model=seq_model)
        case, cost = _in_world(world, multi_pod, lambda m: trace_case(
            arch, shape, m, remat=remat, **kw))
        shp = INPUT_SHAPES[shape]
        n_tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode"
                                       else 1)
        rec.update(_report(case, cost, n_tokens, shp.kind,
                           active_param_count(case.cfg, case.args[0]),
                           mesh_name, chips))
        rec.update(status="ok", t_trace_s=round(time.time() - t0, 1))
    except Exception as e:  # a failure here is a bug of the port: record it
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def run_facade_case(arch: str, *, remat: bool = True, tag: str = "facade",
                    mesh: str = MESH_NAME, multi_pod: bool = False,
                    act_sharding: bool = True) -> dict:
    """The paper's technique: 2 FACADE nodes, each a whole model, one
    round (``steps.build_facade_case``); on the production mesh the node
    axis lies on 'pod'."""
    mesh_name, chips, world = _mesh_of(mesh, multi_pod)
    rec = {"arch": arch, "shape": "facade_pod", "mesh": mesh_name,
           "chips": chips, "status": "?", "tag": tag}
    t0 = time.time()
    try:
        kw = {} if world is None else dict(act_sharding=act_sharding)

        def trace(m):
            case = steps.build_facade_case(arch, remat=remat, abstract=True,
                                           mesh=m, **kw)
            return case, count_step(case.step_fn, case.args, case.context)

        case, cost = _in_world(world, multi_pod, trace)
        rec.update(_report(case, cost, case.n_tokens, "train",
                           active_param_count(case.cfg,
                                              case.args[0].cores),
                           mesh_name, chips))
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
    ap.add_argument("--mesh", choices=(MESH_NAME, "pod"), default=MESH_NAME,
                    help="one card, or the production mesh on a fake world")
    ap.add_argument("--multi-pod", action="store_true",
                    help="(pod 2, data 16, model 16) instead of (16, 16)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-act-sharding", action="store_true",
                    help="drop the activation sharding hooks")
    ap.add_argument("--seq-model", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="sequence-parallel residual anchors (default on)")
    ap.add_argument("--unroll", action="store_true",
                    help="refused: the port's layers are a Python loop")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="jsonl output path")
    args = ap.parse_args(argv)
    if args.unroll:
        ap.error("--unroll: there is no layer scan to unroll (every layer "
                 "is traced)")
    mesh_flags = [f for f, on in (
        ("--multi-pod", args.multi_pod), ("--no-fsdp", args.no_fsdp),
        ("--no-act-sharding", args.no_act_sharding),
        ("--seq-model/--no-seq-model", args.seq_model is not None)) if on]
    if args.mesh == MESH_NAME and mesh_flags:
        ap.error(f"{', '.join(mesh_flags)}: no meaning on one card; pass "
                 "--mesh pod")
    mesh_kw = {} if args.mesh == MESH_NAME else dict(
        mesh="pod", multi_pod=args.multi_pod)
    mesh_name = _mesh_of(args.mesh, args.multi_pod)[0]

    out = pathlib.Path(args.out) if args.out else (
        RESULTS / f"dryrun_{mesh_name}"
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
            rec = run_facade_case(
                a, remat=not args.no_remat, tag=args.tag or "facade",
                **mesh_kw, **({} if not mesh_kw else dict(
                    act_sharding=not args.no_act_sharding)))
        else:
            rec = run_case(a, s, remat=not args.no_remat, tag=args.tag,
                           **mesh_kw, **({} if not mesh_kw else dict(
                               fsdp=not args.no_fsdp,
                               act_sharding=not args.no_act_sharding,
                               seq_model=args.seq_model is not False)))
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
