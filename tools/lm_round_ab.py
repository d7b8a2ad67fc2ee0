#!/usr/bin/env python3
"""Time the LM FACADE rounds of two versions of the port on one card, in
turns.

    python3 tools/lm_round_ab.py BASELINE_DIR [--keys KEY,...] [--out FILE]

``BASELINE_DIR`` is the root of another checkout of this repository (for
example an earlier commit unpacked by ``git archive`` into a git-ignored
directory). In the order baseline, current, current, baseline, each in a
process of its own, the version's ``chip_smoke.py`` builds its kernels
and runs its ``lm_facade_phase`` for each of ``--keys`` (keys of its
``LM_ROUNDS``; default ``llama3.2-1b`` and ``hymba-1.5b``) at full width,
with every check of the phase. Prints the card's name and power limit,
then one JSON object with each run's round times and its profiled
round's wall, busy share and profiler seconds (also written to
``--out``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUN = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs, torch
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build(*sorted(p.stem for p in build.CSRC.glob("*.cu")))
rec, out = {}, {}
for key in sys.argv[2].split(","):
    cs.lm_facade_phase(rec, key)
    r = rec["lm_facade"][key]
    prof = r["profiled_round"]
    out[key] = {"round_1_s": r["round_1_s"], "rounds_2_3_s": r["rounds_2_3_s"],
                "profiled_wall_s": prof["wall_s"],
                "busy_share": prof["busy_share"],
                "profiler_stop_s": prof["profiler_stop_s"],
                "profiler_read_s": prof["profiler_read_s"]}
print("JSON " + json.dumps(out), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline", type=pathlib.Path)
    ap.add_argument("--keys", default="llama3.2-1b,hymba-1.5b")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    runs = []
    for tag, root in (("baseline", args.baseline), ("current", ROOT),
                      ("current", ROOT), ("baseline", args.baseline)):
        proc = subprocess.run(
            [sys.executable, "-c", RUN, str(root.resolve()), args.keys],
            capture_output=True, text=True, timeout=600)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("JSON ")), None)
        if proc.returncode or line is None:
            print(proc.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"{tag} run failed ({proc.returncode})")
        runs.append({"tag": tag, **json.loads(line[5:])})
        print(tag, line[5:], flush=True)
    text = json.dumps({"runs": runs}, indent=1)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
