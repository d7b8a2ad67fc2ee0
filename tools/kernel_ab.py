#!/usr/bin/env python3
"""Time two versions of the port's head-select, flash-attention and wkv
kernels on one card, in turns.

    python3 tools/kernel_ab.py BASELINE_DIR [--out FILE]

``BASELINE_DIR`` holds another version of ``head_select.cu``,
``flash_attention.cu`` and ``wkv.cu`` with the same C interface
(``hs_head_losses`` with its workspace and ``hs_workspace_bytes``,
``fa_forward``, ``wkv_forward``), for example those of
an earlier commit unpacked by ``git archive`` into a git-ignored
directory. Both versions are built with the port's ``nvcc`` flags, each
output is held against the plain version (the tolerances of
``chip_smoke.py``; head select also with equal argmins), and each kernel
is timed with CUDA graphs in the order baseline, current, current,
baseline: head select in fp32 at the FACADE path's shape (n 32, K 2, T 8,
D 513, V 10) and at the reference tests' ``HS_SHAPES[2]`` (K 5, T 128,
D 128, V 1024, one node), and in bf16 at the LM FACADE path's shape (n·K
4, T 1024, D 2048, V 128,256), flash attention in bf16 at llama3.2-1b's
serving shape (B 4, S 512, Hq 32, Hkv 8, D 64) and at S = 4096, wkv at
rwkv6-1.6b's (B 4, S 512, H 32, hd 64). Prints the card's name and power
limit, then one JSON object (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def load(src: pathlib.Path, out: pathlib.Path) -> ctypes.CDLL:
    """Build ``src`` with the port's flags into ``out`` and load it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def hs_bind(lib) -> None:
    """Set the head-select C functions' argument types."""
    lib.hs_head_losses.argtypes = ([ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.hs_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.hs_workspace_bytes.restype = ctypes.c_longlong


def hs_call(lib, feats, heads, labels, out, ws=None):
    """One head-select call; ``ws`` is the LM body's workspace (a float
    tensor of ``hs_workspace_bytes``), unused by the FMA body."""
    n, k, d, v = heads.shape
    dtype = 1 if feats.dtype == torch.bfloat16 else 0
    rc = lib.hs_head_losses(feats.data_ptr(), heads.data_ptr(),
                            labels.data_ptr(), out.data_ptr(),
                            None if ws is None else ws.data_ptr(), n, k,
                            feats.shape[1], d, v, dtype,
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"hs_head_losses returned {rc}")
    return out


def hs_workspace(lib, feats, heads):
    n, k, d, v = heads.shape
    nbytes = lib.hs_workspace_bytes(n, k, feats.shape[1], d, v, 1)
    return torch.empty(nbytes // 4, device="cuda")


def fa_call(lib, q, k, v, out):
    b, s, hq, d = q.shape
    rc = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, s, hq, k.shape[2], d, 1, 0, 1,
                        d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fa_forward returned {rc}")
    return out


def wkv_call(lib, r, k, v, w, u, y, s_out):
    b, s, h, hd = r.shape
    rc = lib.wkv_forward(*(x.data_ptr() for x in (r, k, v, w, u, y, s_out)),
                         b, s, h, hd, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"wkv_forward returned {rc}")
    return y, s_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out_dir = build.BUILD_DIR.parent / "kernel_ab"
    libs = {name: {"baseline": load(args.baseline / f"{name}.cu",
                                    out_dir / f"lib{name}-baseline.so"),
                   "current": ctypes.CDLL(str(build.build(name)[name]))}
            for name in ("head_select", "flash_attention", "wkv")}
    for lib in libs["head_select"].values():
        hs_bind(lib)
    for lib in libs["flash_attention"].values():
        lib.fa_forward.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 8
                                   + [ctypes.c_float, ctypes.c_void_p])
    for lib in libs["wkv"].values():
        lib.wkv_forward.argtypes = ([ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    order = ("baseline", "current", "current", "baseline")
    rec = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
           "order": order}

    hs2 = (1, *cs.HS_SHAPES[2])
    for label, shape, inputs, calls in (
            ("head_select_main", cs.MAIN_SHAPE, cs.hs_main_inputs(seed=99),
             50),
            ("head_select_hs2", hs2,
             cs.hs_case(*hs2, torch.float32, seed=98), 10)):
        want = cs.head_losses_ref(*inputs)
        out = torch.empty_like(want)
        t = {"shape": list(shape), "dtype": "fp32", "max_abs_err": {},
             "ms": {"baseline": [], "current": []}}
        for which in ("baseline", "current"):
            out.fill_(float("nan"))
            got = hs_call(libs["head_select"][which], *inputs, out)
            torch.cuda.synchronize()
            t["max_abs_err"][which] = cs.hs_check(
                f"{label} {which}", got, want)["max_abs_err"]
        for which in order:
            lib = libs["head_select"][which]
            t["ms"][which].append(cs.graph_ms(
                lambda: hs_call(lib, *inputs, out), calls=calls))
        rec[label] = t
        print(label, json.dumps(t), flush=True)

    # the LM regime (bf16 tensor-core body) at the LM FACADE path's shape
    inputs = cs.hs_lm_case(*cs.HS_LM_SHAPE, seed=99, drop=0.0)
    want = cs.head_losses_ref(*inputs)
    out = torch.empty_like(want)
    t = {"shape": list(cs.HS_LM_SHAPE), "dtype": "bf16", "max_abs_err": {},
         "ms": {"baseline": [], "current": []}}
    ws = {w: hs_workspace(lib, *inputs[:2])
          for w, lib in libs["head_select"].items()}
    for which, lib in libs["head_select"].items():
        out.fill_(float("nan"))
        got = hs_call(lib, *inputs, out, ws[which])
        torch.cuda.synchronize()
        t["max_abs_err"][which] = cs.hs_check(
            f"head_select_lm {which}", got, want)["max_abs_err"]
    for which in order:
        lib = libs["head_select"][which]
        t["ms"][which].append(cs.graph_ms(
            lambda: hs_call(lib, *inputs, out, ws[which]), calls=5, reps=5))
    rec["head_select_lm"] = t
    print("head_select_lm", json.dumps(t), flush=True)
    del inputs, want, ws
    torch.cuda.empty_cache()

    for label, shape, calls in (("flash_attention_serve", cs.FA_SERVE, 50),
                                ("flash_attention_long", cs.FA_LONG, 5)):
        q, k, v = cs.fa_inputs(*shape, torch.bfloat16, seed=99)
        want = cs.fa_plain(q.float(), k.float(), v.float())
        out = torch.empty_like(q)
        t = {"shape": list(shape), "dtype": "bf16", "max_abs_err": {},
             "ms": {"baseline": [], "current": []}}
        for which in ("baseline", "current"):
            got = fa_call(libs["flash_attention"][which], q, k, v, out)
            torch.cuda.synchronize()
            t["max_abs_err"][which] = cs.check(
                f"{label} {which}", got, want,
                *cs.FA_TOL[torch.bfloat16])["max_abs_err"]
        for which in order:
            lib = libs["flash_attention"][which]
            t["ms"][which].append(cs.graph_ms(
                lambda: fa_call(lib, q, k, v, out), calls=calls))
        rec[label] = t
        print(label, json.dumps(t), flush=True)

    args_w = cs.wkv_inputs(*cs.RW_SERVE, seed=99)
    y_ref, s_ref = cs.wkv_scan(*args_w)
    b, s, h, hd = cs.RW_SERVE
    y = torch.empty_like(args_w[0])
    s_out = torch.empty((b, h, hd, hd), device="cuda")
    t = {"shape": list(cs.RW_SERVE), "max_abs_err": {},
         "ms": {"baseline": [], "current": []}}
    for which in ("baseline", "current"):
        wkv_call(libs["wkv"][which], *args_w, y, s_out)
        torch.cuda.synchronize()
        t["max_abs_err"][which] = max(
            cs.check(f"wkv y {which}", y, y_ref, cs.RW_TOL)["max_abs_err"],
            cs.check(f"wkv state {which}", s_out, s_ref,
                     cs.RW_TOL)["max_abs_err"])
    for which in order:
        lib = libs["wkv"][which]
        t["ms"][which].append(cs.graph_ms(
            lambda: wkv_call(lib, *args_w, y, s_out), calls=50))
    rec["wkv_serve"] = t
    print("wkv_serve", json.dumps(t), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
