#!/usr/bin/env python3
"""Split the time of the head-select kernel's LM-regime body on one card.

    python3 tools/hs_lm_ablate.py [--out FILE]

Builds ``csrc/head_select.cu`` four times with the port's ``nvcc`` flags
and ``-DHS_LM_ABLATE=`` 0 (the port's body), 1 (the fold cut out), 2 (the
``wgmma`` products cut out) and 3 (both: the TMA ring alone, its
consumers only waiting on and handing back each stage), and times each
at the LM FACADE path's shape (n·K 4, T 1024, D 2048, V 128,256, bf16)
with CUDA graphs, in the order 0, 1, 2, 3, 3, 2, 1, 0, ``--rounds``
times (the medians are reported beside every time). Beside them, as a
yardstick of the card's tensor-core rate at that shape, the per (node,
head) bf16 ``torch.matmul`` alone (the product half of the library call),
and the SM clock and power draw that ``nvidia-smi`` reads every 100 ms
while variant 0 runs for about ``--sustain`` seconds. Only variant 0
computes the function; the others' outputs are discarded. Prints the
card's name and power limit, then one JSON object (also written to
``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kernel_ab import hs_bind, hs_call, hs_workspace  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

VARIANTS = {0: "body", 1: "no_fold", 2: "no_products", 3: "loads_only"}


def build_variants(out_dir: pathlib.Path) -> dict:
    """All variants compiled together; {variant: loaded library}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "head_select.cu"
    procs = {}
    for var in VARIANTS:
        lib = out_dir / f"libhead_select-ablate{var}.so"
        procs[var] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, f"-DHS_LM_ABLATE={var}", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for var, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {var}:\n{log}")
        libs[var] = ctypes.CDLL(str(lib))
        hs_bind(libs[var])
    return libs


def sustained(fn, seconds: float) -> dict:
    """``fn()`` repeated for about ``seconds`` while ``nvidia-smi`` samples
    the SM clock and power draw every 100 ms; the medians of the samples
    stamped inside that window, and the host-clock time per call."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    fn()
    torch.cuda.synchronize()
    time.sleep(0.5)                     # nvidia-smi is sampling by now
    start, t0, calls = time.time(), time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        calls += 20
    wall = time.perf_counter() - t0
    end = time.time()
    smi.terminate()
    busy = []
    for line in smi.communicate()[0].splitlines():
        stamp, clock, power = (f.strip() for f in line.split(","))
        at = datetime.datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f")
        if start + 0.2 <= at.timestamp() <= end:
            busy.append((float(clock), float(power)))
    return {"ms_per_call": wall / calls * 1e3, "calls": calls,
            "samples": len(busy),
            "sm_clock_mhz": statistics.median(b[0] for b in busy)
            if busy else None,
            "power_w": statistics.median(b[1] for b in busy)
            if busy else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sustain", type=float, default=3.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hs_lm_ablate: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(build.BUILD_DIR.parent / "hs_lm_ablate")
    feats, heads, labels = cs.hs_lm_case(*cs.HS_LM_SHAPE, seed=99, drop=0.0)
    want = cs.head_losses_ref(feats, heads, labels)
    out = torch.empty_like(want)
    ws = hs_workspace(libs[0], feats, heads)
    got = hs_call(libs[0], feats, heads, labels, out, ws)
    torch.cuda.synchronize()
    check = cs.hs_check("head_select_lm body", got, want)
    bound = cs.hs_bound(feats, heads, labels)
    rec = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
           "shape": list(cs.HS_LM_SHAPE), "bound_ms": bound[0],
           "bound_by": bound[1], "max_rel_err": check["max_rel_err"],
           "ms": {name: [] for name in VARIANTS.values()}}
    order = (list(VARIANTS) + list(reversed(VARIANTS))) * args.rounds
    for var in order:
        lib = libs[var]
        rec["ms"][VARIANTS[var]].append(cs.graph_ms(
            lambda: hs_call(lib, feats, heads, labels, out, ws), calls=5,
            reps=5))
        print(VARIANTS[var], rec["ms"][VARIANTS[var]][-1], flush=True)
    rec["median_ms"] = {name: statistics.median(ms)
                        for name, ms in rec["ms"].items()}
    n, k = heads.shape[:2]
    rec["matmul_ms"] = cs.graph_ms(lambda: [
        torch.matmul(feats[i], heads[i, j]) for i in range(n)
        for j in range(k)], calls=2, reps=5)
    rec["sustained_body"] = sustained(
        lambda: hs_call(libs[0], feats, heads, labels, out, ws),
        args.sustain)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
