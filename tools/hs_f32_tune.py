#!/usr/bin/env python3
"""Time the head-select kernel's two fp32 bodies, the SIMT tiled one and the
tensor cores' (3xTF32), against builds of them with other tile constants,
on one card.

    python3 tools/hs_f32_tune.py [--shape N K T D V] [--out FILE]

Builds ``csrc/head_select.cu`` once for each (body, constants) of
:data:`VARIANTS`, the constants put in place of the source's (the first
variant of each body is the source as it stands: for the tensor cores
``kTcStages``, the stages of the TMA ring; for
the SIMT body ``kF32BK``, ``kF32Blocks`` and ``kF32BV``, the D chunk,
blocks an SM and vocab tile), with the port's ``nvcc`` flags; holds each
against the plain version (``chip_smoke``'s ``HS_TOL``, equal argmins)
and times each with CUDA graphs at ``--shape`` (default: a four-card
FACADE rank's step 2c at the reference's B 8 of S 256, n·K 2, T 2048, D
2048, V 128,256, fp32), in the order of :data:`VARIANTS` and back,
``--rounds`` times. Beside them: the fp32 ``torch.matmul`` alone and the
library call (``matmul`` and ``cross_entropy``), both bounds (the fp32
pipes' and three TF32 products', ``chip_smoke.hs_bound``), and the SM
clock and power draw that ``nvidia-smi`` reads while each body's source
build runs for ``--sustain`` seconds (``hs_lm_ablate.sustained``).
Prints the card's name and power limit, then one JSON object (also
written to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hs_lm_ablate import sustained  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.head_select.ops import BODIES  # noqa: E402

# (body, constants in place of the source's): each body's source first
VARIANTS = (("fp32_tensor_core", ()),
            ("fp32_tensor_core", (("kTcStages", 3),)),
            ("fp32_tiled", ()),
            ("fp32_tiled", (("kF32BK", 32), ("kF32Blocks", 2),
                            ("kF32BV", 128))))


def variant_source(consts) -> str:
    src = (build.CSRC / "head_select.cu").read_text()
    for name, value in consts:
        line = next(ln for ln in src.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        src = src.replace(line, f"constexpr int {name} = {value};")
    return src


def label(var) -> str:
    body, consts = var
    return "_".join([body] + [f"{name}{value}" for name, value in consts])


def build_variants(out_dir: pathlib.Path) -> dict:
    """All variants compiled together; {variant: (library, ptxas lines of
    its body's tile kernel)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var in VARIANTS:
        src = out_dir / f"hs_{label(var)}.cu"
        src.write_text(variant_source(var[1]))
        lib = src.with_suffix(".so")
        procs[var] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for var, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {var}:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.hs_head_losses_for.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.hs_workspace_bytes_for.argtypes = [ctypes.c_int] * 7
        lib.hs_workspace_bytes_for.restype = ctypes.c_longlong
        kernel = cs.K1_BODY_KERNEL[var[0]]
        lines, keep = log.splitlines(), []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and kernel in line:
                keep += [ln.strip() for ln in lines[i + 1:i + 4]]
        libs[var] = (lib, keep)
    return libs


def call(lib, body, feats, heads, labels, out, ws):
    n, k, d, v = heads.shape
    rc = lib.hs_head_losses_for(
        BODIES.index(body), feats.data_ptr(), heads.data_ptr(),
        labels.data_ptr(), out.data_ptr(), ws.data_ptr(), n, k,
        feats.shape[1], d, v, 0, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"hs_head_losses_for returned {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=5,
                    default=(2, 1, 2048, 2048, 128256))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--sustain", type=float, default=3.0)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hs_f32_tune: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(build.BUILD_DIR.parent / "hs_f32_tune")
    shape = tuple(args.shape)
    feats, heads, labels = cs.hs_lm_case(*shape, seed=99, drop=0.0,
                                         dtype=torch.float32)
    want = cs.head_losses_ref(feats, heads, labels)
    out = torch.empty_like(want)
    n, k, t, d, v = shape
    rec = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
           "shape": list(shape), "variants": {}}
    for tc32 in (False, True):
        key = "bound_tf32" if tc32 else "bound_fp32"
        rec[key + "_ms"], rec[key + "_by"] = cs.hs_bound(
            feats, heads, labels, tc32=tc32)[:2]
    ws = {}
    for var, (lib, ptxas) in libs.items():
        ws[var] = torch.empty(max(lib.hs_workspace_bytes_for(
            BODIES.index(var[0]), n, k, t, d, v, 0), 4) // 4, device="cuda")
        got = call(lib, var[0], feats, heads, labels, out, ws[var])
        torch.cuda.synchronize()
        check = cs.hs_check(f"hs_f32_tune {label(var)}", got, want)
        rec["variants"][label(var)] = {
            "max_rel_err": check["max_rel_err"], "ptxas": ptxas, "ms": []}
    order = (list(VARIANTS) + list(reversed(VARIANTS))) * args.rounds
    for var in order:
        lib = libs[var][0]
        ms = cs.graph_ms(lambda: call(lib, var[0], feats, heads, labels,
                                      out, ws[var]), calls=2, reps=3)
        rec["variants"][label(var)]["ms"].append(ms)
        print(label(var), ms, flush=True)
    for entry in rec["variants"].values():
        entry["median_ms"] = statistics.median(entry["ms"])
    rec["matmul_ms"] = cs.graph_ms(
        lambda: torch.matmul(feats[:, None], heads), calls=2, reps=3)
    rec["library_ms"] = cs.graph_ms(
        lambda: cs.hs_library(feats, heads, labels), calls=2, reps=3)
    for var in VARIANTS:
        if not var[1]:                          # each body's source
            lib = libs[var][0]
            rec[f"sustained_{var[0]}"] = sustained(
                lambda: call(lib, var[0], feats, heads, labels, out,
                             ws[var]), args.sustain)
    rec["sustained_matmul"] = sustained(
        lambda: torch.matmul(feats[:, None], heads), args.sustain)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
