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

    python3 tools/kernel_ab.py --library [--out FILE]

times the current kernels against the PyTorch call that computes the
same function (``chip_smoke.py``'s yardsticks, which the port never
calls), in the order library, kernel, kernel, library, beside the bound
worked out from the shapes (``chip_smoke.hs_bound``, ``fa_bound``) and
the plain version's time, at the shapes of :data:`LIBRARY_SHAPES`; K1
there also on its FMA body where the dispatch rule gives another one
(``head_losses(body="fma")``) and that body still finishes, and in fp32 on
both fp32 bodies forced, the SIMT one and the tensor cores' (3xTF32), in
turns (tensor cores, SIMT, SIMT, tensor cores), beside the fp32
``matmul`` alone and both bounds (the fp32 pipes' and three TF32
products').
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


# (label, kernel, shape, dtype, the FMA body's timing) timed against the
# library call: K1 at the reference tests' HS_SHAPES[2] (K 5, T 128, D
# 128, V 1024, one node; the fp32 tiled body, beside the FMA body), at a
# rank's n 8 of the node mesh's FACADE round on four cards (32 nodes over
# 4 ranks: n 8, K 2, T 8, D 513, V 10; the FMA body), at a rank's step 2c
# in tools/lm_mesh_run.py's four-card FACADE step (one node's k 2 heads as
# n*K 2 rows of K' 1, T = 2 sequences of 256 tokens, D 2048, V 128,256,
# fp32; and at the reference's B 8 of S 256 a node, T 2048) and at the
# one-card fp32 llama FACADE round's (n·K 4 as 1 node of K 4, T 1024),
# and at hymba-1.5b's LM FACADE step 2c
# (n·K 4, T 1024, D 1600, V 32,001, bf16; the tensor cores through the
# padded copy); K2 at the prefill_32k length on one KV group (B 1, S
# 32,768, Hq 4, Hkv 1, D 64, bf16, causal). The FMA body, where the rule
# gives another body, is timed in turns with it ("graph") or, where it
# takes seconds a call, once by CUDA events ("once"), or not at all (None)
# where it would take tens of seconds.
LIBRARY_SHAPES = (
    ("head_select_hs2", "head_select", (1, 5, 128, 128, 1024),
     torch.float32, "graph"),
    ("head_select_node_rank", "head_select", (8, 2, 8, 513, 10),
     torch.float32, None),
    ("head_select_facade_pod_rank", "head_select", (2, 1, 512, 2048, 128256),
     torch.float32, "once"),
    ("head_select_f32_round", "head_select", (1, 4, 1024, 2048, 128256),
     torch.float32, None),
    ("head_select_facade_pod_rank_b8", "head_select",
     (2, 1, 2048, 2048, 128256), torch.float32, None),
    ("head_select_hymba", "head_select", (4, 1, 1024, 1600, 32001),
     torch.bfloat16, "once"),
    ("flash_attention_steps", "flash_attention", (1, 4, 1, 32768, 64),
     torch.bfloat16, None))


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


def library_inputs(kernel, shape, dtype):
    """Inputs at ``shape`` and (the kernel's call, the library call, the
    plain version, the FMA body's call, the bound and what bounds it);
    K1's inputs drawn on the card (``chip_smoke.hs_lm_case``), its library
    call an fp32 ``matmul`` and ``cross_entropy`` in fp32 and per (node,
    head) in bf16; and for K1 in fp32 a dict of each fp32 body's forced
    call, the ``matmul`` alone and both bounds (else empty)."""
    if kernel == "head_select":
        feats, heads, labels = cs.hs_lm_case(*shape, seed=97, dtype=dtype)
        body = cs.hs_ops.body_for(*shape, dtype)
        bound_ms, bound_by, _, _ = cs.hs_bound(
            feats, heads, labels, tc32=body == "fp32_tensor_core")
        library = (cs.hs_library if dtype == torch.float32
                   else cs.hs_lm_library)
        fp32 = {}
        if dtype == torch.float32:
            fp32 = {b: (lambda b=b: cs.head_losses(feats, heads, labels,
                                                   body=b))
                    for b in cs.F32_BODIES}
            fp32["matmul"] = lambda: torch.matmul(feats[:, None], heads)
            for tc32 in (False, True):
                key = "bound_tf32" if tc32 else "bound_fp32"
                fp32[key + "_ms"] = cs.hs_bound(feats, heads, labels,
                                                tc32=tc32)[0]
        return ((lambda: cs.head_losses(feats, heads, labels)),
                (lambda: library(feats, heads, labels)),
                (lambda: cs.head_losses_ref(feats, heads, labels)),
                (lambda: cs.head_losses(feats, heads, labels, body="fma")),
                bound_ms, bound_by, fp32)
    q, k, v = cs.fa_inputs(*shape, dtype, seed=97)
    bound_ms, bound_by, _, _ = cs.fa_bound(q, k, v)
    return ((lambda: cs.flash_attention(q, k, v, causal=True)),
            (lambda: cs.fa_library(q, k, v)),
            (lambda: cs.fa_plain(q.float(), k.float(), v.float())),
            None, bound_ms, bound_by, {})


def library_main(out_path) -> dict:
    """Each of ``LIBRARY_SHAPES``: the kernel held against its plain
    version, then it and its library call timed in turns (CUDA graphs)
    and the plain version once (CUDA events)."""
    build.build("head_select", "flash_attention")
    rec = {"order": ("library", "kernel", "kernel", "library"),
           "fma_order": ("fma", "kernel", "kernel", "fma")}
    for label, kernel, shape, dtype, fma_timing in LIBRARY_SHAPES:
        call, library, plain, fma, bound_ms, bound_by, fp32 = \
            library_inputs(kernel, shape, dtype)
        got, want = call(), plain()
        torch.cuda.synchronize()
        tol = ((cs.HS_TOL,) if kernel == "head_select" else
               cs.FA_TOL[torch.bfloat16])
        check = (cs.hs_check if kernel == "head_select" else cs.check)(
            label, got, want, *tol)
        del got, want
        big = shape[-1] * shape[-2] > 1 << 26 or shape[3] > 1 << 14
        t = {"shape": list(shape), "dtype": str(dtype),
             "max_abs_err": check["max_abs_err"], "bound_ms": bound_ms,
             "bound_by": bound_by, "ms": [], "library_ms": []}
        if kernel == "head_select":
            t["body"] = cs.hs_ops.body_for(*shape, dtype)
        for which in rec["order"]:
            fn = library if which == "library" else call
            t["library_ms" if which == "library" else "ms"].append(
                cs.graph_ms(fn, calls=1 if big else 20,
                            reps=3 if big else 7))
        if fma_timing == "graph":
            t["fma_ms"] = [cs.graph_ms(fma if which == "fma" else call,
                                       calls=20, reps=7)
                           for which in rec["fma_order"]]
        elif fma_timing == "once":
            t["fma_ms"] = cs.event_ms(fma)
        if fp32:
            order = ("fp32_tensor_core", "fp32_tiled", "fp32_tiled",
                     "fp32_tensor_core")
            t["fp32_bodies"] = {"order": order, **{b: [] for b in order}}
            for b in order:
                t["fp32_bodies"][b].append(cs.graph_ms(
                    fp32[b], calls=1 if big else 20, reps=3 if big else 7))
            t["matmul_ms"] = cs.graph_ms(fp32["matmul"],
                                         calls=1 if big else 20,
                                         reps=3 if big else 7)
            t.update({key: fp32[key] for key in ("bound_fp32_ms",
                                                  "bound_tf32_ms")})
        t["plain_ms"] = cs.event_ms(plain)
        rec[label] = t
        print(label, json.dumps(t), flush=True)
        del call, library, plain, fma, fp32
        torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", type=pathlib.Path, nargs="?")
    ap.add_argument("--library", action="store_true",
                    help="time the kernels against their library calls "
                         "(no baseline)")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if (args.baseline is None) != args.library:
        ap.error("give either BASELINE_DIR or --library")
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.library:
        rec = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
               **library_main(args.out)}
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(rec, indent=1))
        print(json.dumps(rec), flush=True)
        return 0
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
