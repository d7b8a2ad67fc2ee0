#!/usr/bin/env python3
"""Drive the PyTorch port of the FACADE reproduction on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; it puts ``src`` on the path itself and
imports only ``repro_torch``, torch and numpy. Phases, in order (any
failure raises and exits non-zero, before the last line is printed):

1. the card: ``nvidia-smi`` name and power limit;
2. kernels: build every CUDA source of the port with ``nvcc`` (all started
   together), then hold each kernel against its plain PyTorch version on
   the card — head select at the reference kernel tests' shapes (fp32 and
   bf16, ~10% of labels excluded) and at the main path's shape — and time
   kernel, plain version and the library yardstick with CUDA graphs;
3. the main path: ``run_experiment`` for FACADE and EL at paper scale
   (full-width GN-LeNet, 32 nodes in clusters 24:8, degree 4, H = 10,
   B = 8), with every kernel's launch count set to 0 just before and read
   just after; checks finite parameters, one head-select launch per FACADE
   round and the bytes per round against the formula;
4. a small input run on the card and on the CPU from the same seed, which
   must agree;
5. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off for every matmul and convolution of the run. A JSON record of
every number goes to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.facade_paper import lenet  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.core.bindings import make_binding  # noqa: E402
from repro_torch.core.runner import run_experiment  # noqa: E402
from repro_torch.data.synthetic import SynthSpec, make_clustered_data  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.head_select import head_losses, head_losses_ref  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS = 67e12            # H100 SXM data sheet, fp32 outside tensor cores
# (K, T, D, V): the reference kernel tests' HS_SHAPES (tests/test_kernels.py)
HS_SHAPES = [(2, 128, 64, 256), (3, 256, 64, 512), (5, 128, 128, 1024)]
MAIN_SHAPE = (32, 2, 8, 513, 10)        # n, K, T = B, D = 512 + bias, V
HS_TOL = 2e-5       # same inputs, fp32 accumulation on both sides
PAPER = dict(k=2, degree=4, local_steps=10, batch_size=8, lr=0.05, seed=0)
ROUNDS, EVAL_EVERY = 8, 4
SMALL_TOL = 0.1     # accuracy across devices (reference precedent)


def log(*args):
    print(*args, flush=True)


def graph_ms(fn, calls: int = 50, reps: int = 7) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events; the median per call."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def hs_case(n, k, t, d, v, dtype, seed, drop=0.1):
    g = torch.Generator().manual_seed(seed)
    feats = 0.5 * torch.randn((n, t, d), generator=g)
    heads = 0.05 * torch.randn((n, k, d, v), generator=g)
    labels = torch.randint(0, v, (n, t), generator=g, dtype=torch.int32)
    labels[torch.rand((n, t), generator=g) < drop] = -1
    return (feats.to(dtype).cuda(), heads.to(dtype).cuda(), labels.cuda())


def hs_library(feats, heads, labels):
    """One PyTorch product and cross-entropy for the same function (the
    yardstick; the port never calls it)."""
    n, k, d, v = heads.shape
    t = feats.shape[1]
    logits = torch.matmul(feats.float()[:, None], heads.float())
    nll = F.cross_entropy(logits.reshape(-1, v),
                          labels.long()[:, None].expand(n, k, t).reshape(-1),
                          ignore_index=-1, reduction="none").view(n, k, t)
    return nll.sum(-1) / (labels >= 0).sum(-1, keepdim=True).clamp(min=1)


def hs_bound(feats, heads, labels):
    n, k, d, v = heads.shape
    nbytes = (feats.numel() * feats.element_size()
              + heads.numel() * heads.element_size()
              + labels.numel() * 4 + n * k * 4)
    valid = int((labels >= 0).sum())              # tokens this data needs
    flops = 2 * k * valid * d * v
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations"), nbytes, flops


def kernel_phase(rec):
    t0 = time.perf_counter()
    libs = build.build(*sorted(p.stem for p in build.CSRC.glob("*.cu")))
    rec["build_s"] = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {rec['build_s']:.1f} s")
    for name, lib in libs.items():
        report = lib.with_suffix(".log")
        if report.exists():
            log(f"nvcc {name}: " + " | ".join(
                ln.strip() for ln in report.read_text().splitlines()
                if "registers" in ln or "spill" in ln))

    checks = []
    cases = [((1,) + s, dt) for s in HS_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(MAIN_SHAPE, torch.float32)]
    for i, (shape, dtype) in enumerate(cases):
        feats, heads, labels = hs_case(*shape, dtype, seed=i)
        if shape == MAIN_SHAPE:
            feats[..., -1] = 1.0                  # LeNet's folded bias
            labels = labels.abs()                 # the main path has no -1
        got = head_losses(feats, heads, labels)
        torch.cuda.synchronize()
        want = head_losses_ref(feats, heads, labels)
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
        same_argmin = bool(torch.equal(got.argmin(1), want.argmin(1)))
        check = {"shape": list(shape), "dtype": str(dtype),
                 "max_abs_err": err, "max_rel_err": rel,
                 "argmin_equal": same_argmin}
        checks.append(check)
        log("head_select check", json.dumps(check))
        if not (np.isfinite(err) and rel <= HS_TOL and same_argmin):
            raise AssertionError(f"head_select disagrees with its plain "
                                 f"version: {check}")
    rec["head_select_checks"] = checks

    feats, heads, labels = hs_case(*MAIN_SHAPE, torch.float32, seed=99)
    feats[..., -1] = 1.0
    labels = labels.abs()
    bound_ms, bound_by, nbytes, flops = hs_bound(feats, heads, labels)
    timing = {}
    for label, fn in (("ms", head_losses), ("plain_ms", head_losses_ref),
                      ("library_ms", hs_library),
                      ("ms_again", head_losses),
                      ("plain_ms_again", head_losses_ref)):
        timing[label] = graph_ms(lambda: fn(feats, heads, labels))
    t0 = time.perf_counter()
    for _ in range(100):
        head_losses(feats, heads, labels)
    torch.cuda.synchronize()
    timing["eager_call_ms"] = (time.perf_counter() - t0) * 10
    rec["head_select_timing"] = dict(
        timing, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
        flops=flops, shape=list(MAIN_SHAPE))
    log("head_select timing", json.dumps(rec["head_select_timing"]))
    return {"name": "head_select", "route": "cuda",
            "source": "src/repro_torch/csrc/head_select.cu",
            "replaces": "src/repro/kernels/head_select/kernel.py:62",
            "launches": None,
            "max_abs_err": checks[-1]["max_abs_err"],
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timing["library_ms"]}


def round_bytes(cfg, algo: str, n: int, degree: int) -> float:
    binding = make_binding(cfg)
    params = binding.init(torch.Generator().manual_seed(0))
    if algo == "el":
        return float(np.float32(n * degree * split.tree_size_bytes(params)))
    core, head = split.split_params(params, binding.head_keys)
    payload = split.tree_size_bytes(core) + split.tree_size_bytes(head) + 4
    return float(np.float32(n * degree * payload))


def main_path_phase(rec):
    spec = SynthSpec(n_classes=10, image_size=32, samples_per_class=32,
                     test_per_class=64, seed=3)
    t0 = time.perf_counter()
    ds = make_clustered_data(spec, (24, 8), ("rot0", "rot180"))
    rec["data_s"] = time.perf_counter() - t0
    cfg = lenet()
    n = ds.n_nodes
    head_losses.launches = 0
    results = {}
    for algo in ("facade", "el"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_experiment(algo, cfg, ds, rounds=ROUNDS,
                             eval_every=EVAL_EVERY, device="cuda", **PAPER)
        torch.cuda.synchronize()
        results[algo] = (res, time.perf_counter() - t0)
    launches = head_losses.launches

    out = {"launches": {"head_select": launches}}
    if launches != ROUNDS:
        raise AssertionError(f"head_select launched {launches} times in "
                             f"{ROUNDS} FACADE rounds")
    for algo, (res, wall) in results.items():
        leaves = tree_leaves(res.models)
        if not all(bool(torch.isfinite(l).all()) for l in leaves):
            raise AssertionError(f"{algo}: non-finite parameters")
        if leaves[0].shape[0] != n or leaves[0].device.type != "cuda":
            raise AssertionError(f"{algo}: models not [n, ...] on the card")
        want = round_bytes(cfg, algo, n, PAPER["degree"])
        per_round = np.diff([0.0] + res.comm.bytes)
        if len(per_round) != ROUNDS or not (per_round == want).all():
            raise AssertionError(f"{algo}: bytes per round {per_round} != "
                                 f"{want}")
        accs = res.final_acc
        if not (len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)
                and np.isfinite(res.best_fair_acc())):
            raise AssertionError(f"{algo}: bad accuracies {accs}")
        out[algo] = {"wall_s": wall, "rounds_per_s": ROUNDS / wall,
                     "final_acc": accs, "fair_acc": res.fair_acc[-1][1],
                     "dp": res.dp, "eo": res.eo,
                     "bytes_per_round": want}
        if algo == "facade":
            out[algo]["final_cluster_id"] = \
                res.cluster_history[-1][1].tolist()
        log(f"{algo}: {ROUNDS} rounds in {wall:.2f} s "
            f"({ROUNDS / wall:.2f} rounds/s), acc per cluster {accs}, "
            f"fair_acc {res.fair_acc[-1][1]:.4f}, bytes/round {want:.0f}")
    rec["main_path"] = out
    return launches


def small_input_phase(rec):
    """The same tiny experiment on the card and on the CPU (one seed, so
    the same draws): bytes and cluster ids exact, accuracy within 0.1."""
    spec = SynthSpec(n_classes=4, image_size=16, samples_per_class=8,
                     test_per_class=16, seed=3)
    ds = make_clustered_data(spec, (6, 2), ("rot0", "rot180"))
    cfg = lenet(smoke=True).replace(n_classes=4)
    kw = dict(rounds=4, k=2, degree=2, local_steps=3, batch_size=8,
              lr=0.05, eval_every=2, seed=0, head_jitter=0.05)
    out = {}
    for algo in ("facade", "el"):
        gpu = run_experiment(algo, cfg, ds, device="cuda", **kw)
        cpu = run_experiment(algo, cfg, ds, device="cpu", **kw)
        diff = float(np.abs(np.subtract(gpu.final_acc, cpu.final_acc)).max())
        same_cid = all(np.array_equal(a, b) for (_, a), (_, b) in
                       zip(gpu.cluster_history, cpu.cluster_history))
        out[algo] = {"acc_diff": diff, "cluster_ids_equal": same_cid,
                     "bytes_equal": gpu.comm.bytes == cpu.comm.bytes}
        log(f"small input {algo}: card vs CPU {json.dumps(out[algo])}")
        if not (diff <= SMALL_TOL and same_cid and gpu.comm.bytes ==
                cpu.comm.bytes):
            raise AssertionError(f"{algo}: card and CPU disagree {out}")
    rec["small_input"] = out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to drive",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    rec = {"nvidia_smi": smi, "device": kind,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    entry = kernel_phase(rec)
    entry["launches"] = main_path_phase(rec)
    small_input_phase(rec)
    rec["kernels"] = [entry]
    rec["total_s"] = time.perf_counter() - t0
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(rec, indent=1))
    log(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
