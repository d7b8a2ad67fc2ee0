#!/usr/bin/env python3
"""Count how often the bf16 flash-attention kernel misses one bf16 ulp.

    python3 tools/fa_accuracy.py [--seeds N] [--out FILE]

On one card, for q and k at std 0.3, 1 and 3 (scaled scores of about
0.1, 1 and 9 std) and v at std 0.3, at llama3.2-1b's serving shape (B 4,
S 512, Hq 32, Hkv 8, D 64; N seeds), at S = 4096 (B 1; 2 seeds) and at
stablelm-12b's serving shape (D 160; N seeds),
counts the outputs that ``chip_smoke.py``'s bf16 check would refuse: more
than 1e-6 + 2^-8 |answer| from the plain version run in fp32, and from
the plain version run in fp64. The same counts for the fp32 kernel's
output rounded once to bf16 show what an fp32 computation of the same
inputs gives. Prints the card's name and power limit, then one JSON
object (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

QK_STDS = (0.3, 1.0, 3.0)


def misses(got, want) -> int:
    """Outputs beyond one bf16 ulp (relative 2^-8) plus 1e-6 of ``want``."""
    want = want.double()
    return int(((got.double() - want).abs()
                > 1e-6 + 2.0 ** -8 * want.abs()).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fa_accuracy: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rec = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
           "cases": []}
    for shape, seeds in ((cs.FA_SERVE, args.seeds), (cs.FA_LONG, 2),
                         (cs.FA_D160, args.seeds)):
        for std in QK_STDS:
            c = {"shape": list(shape), "qk_std": std, "seeds": seeds,
                 "outputs": seeds * shape[0] * shape[1] * shape[3]
                 * shape[4],
                 "bf16_vs_fp32": 0, "bf16_vs_fp64": 0,
                 "fp32_kernel_vs_fp32": 0, "fp32_kernel_vs_fp64": 0}
            for seed in range(seeds):
                q, k, v = cs.fa_inputs(*shape, torch.bfloat16, seed=seed,
                                       qk_std=std)
                got = flash_attention(q, k, v)
                f32 = flash_attention(q.float(), k.float(),
                                      v.float()).bfloat16()
                for ref in ("fp32", "fp64"):
                    dt = torch.float32 if ref == "fp32" else torch.float64
                    want = cs.fa_plain(q.to(dt), k.to(dt), v.to(dt))
                    c[f"bf16_vs_{ref}"] += misses(got, want)
                    c[f"fp32_kernel_vs_{ref}"] += misses(f32, want)
                    del want
            rec["cases"].append(c)
            print(json.dumps(c), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
