#!/usr/bin/env python3
"""Time the segment engine's drivers of two versions of the port on one
card, in turns.

    python3 tools/driver_ab.py BASELINE_DIR [--out FILE]

``BASELINE_DIR`` is the root of another checkout of this repository (for
example an earlier commit unpacked by ``git archive`` into a git-ignored
directory). In the order baseline, current, current, baseline, each in a
process of its own, the version's ``chip_smoke.py`` makes the paper-scale
GN-LeNet data and runs its ``engine_phase`` (the engine and the loop at
steady state, 40 rounds with an eval every 20, seed 1 of one
``EngineCache``) and, where the version has it, its ``pipeline_phase``
(serialized and pipelined, 40 rounds with an eval every 10). Each
phase's own checks still hold. Prints the card's name and power limit,
then one JSON object with each run's rounds per second (also written to
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
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rec = {}
ds = cs.paper_lenet_data(rec)
cs.engine_phase(rec, ds)
out = {"engine": {a: {k: g[k] for k in ("engine_rounds_per_s",
                                          "loop_rounds_per_s")}
                  for a, g in rec["engine"]["steady"].items()}}
if hasattr(cs, "pipeline_phase"):
    cs.pipeline_phase(rec, ds)
    out["pipeline"] = {a: {k: g[k] for k in ("serialized_rounds_per_s",
                                             "pipelined_rounds_per_s")}
                       for a, g in rec["pipeline"].items()}
print("JSON " + json.dumps(out), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline", type=pathlib.Path)
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
            [sys.executable, "-c", RUN, str(root.resolve())],
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
