#!/usr/bin/env python3
"""The node mesh on several cards: FACADE's node axis split over ranks.

    torchrun --nproc-per-node 4 tools/mesh_run.py [--reps 3] [--out FILE]
    python -m torch.distributed.run --nproc-per-node 4 tools/mesh_run.py

One process a card (``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; NCCL). At paper scale on GN-LeNet (``chip_smoke.py``'s data
and ``PAPER`` settings: 32 nodes, 8 a card on four; FACADE's heads
jittered at init, ``HEAD_JITTER``), ``chip_smoke.ROUNDS`` rounds with an
eval every ``chip_smoke.EVAL_EVERY``:

- the five algorithms with ``mesh=(P,)`` on every rank, without a medium
  and under ``edge-v2`` with ``chip_smoke.MESH_FAULTS`` and
  ``Obs(ObsConfig())``, then ``mesh=None`` on rank 0's card (the other
  ranks wait at a barrier): every rank's run the same, and against
  ``mesh=None`` the bytes and simulated seconds exact, the cluster
  histories equal, the accuracies within 0.1, the frames' counts exact
  and their norms within 1e-5; whether the run came out bit for bit is
  recorded; K1's launches on each rank in FACADE's meshed run;
- FACADE's steady rate, meshed and ``mesh=None`` (rank 0's card): one
  ``EngineCache`` each, whose seed-0 run captures, then ``--reps`` timed
  runs of ``chip_smoke.NET_RATE_ROUNDS`` rounds of seed 1 in turns
  (host clock between two synchronises); each rank's peak memory;
- one replayed meshed FACADE segment of ``NET_RATE_ROUNDS`` rounds under
  ``torch.profiler`` on every rank: the NCCL kernels' (the all-gathers')
  device seconds and share of the device's busy time, K1's executions.

Rank 0 prints each card's name and power limit, then one JSON object
(also written to ``--out``). Exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import threading

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.bindings import (gossip_mix, local_sgd,  # noqa: E402
                                       make_binding, node_matmul)
from repro_torch.core.cache import EngineCache  # noqa: E402
from repro_torch.core.runner import (ALGOS, TorchDraws,  # noqa: E402
                                     algo_program, run_experiment)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.head_select import head_losses, head_losses_ref  # noqa: E402
from repro_torch.netsim import NetworkConfig  # noqa: E402
from repro_torch.obs import Obs, ObsConfig  # noqa: E402

TOL = 0.1            # the reference's accuracy bound on a real mesh
NORM_TOL = 1e-5
# FACADE's heads decorrelated at init, as the reference's mesh test runs
# them: with identical heads step 2c compares equal losses, and another
# summation order on another batch of nodes flips such ties
HEAD_JITTER = 0.05
NORMS = ("update_norm", "param_norm")


def compare(ref, got, ref_frames=None, got_frames=None) -> dict:
    """``got`` (a meshed run) against ``ref`` (``mesh=None``), the node
    mesh's contract; ``ok`` holds it, ``bit_for_bit`` says whether the
    runs are one run."""
    cids = len(ref.cluster_history) == len(got.cluster_history) and all(
        r1 == r2 and np.array_equal(c1, c2) for (r1, c1), (r2, c2) in
        zip(ref.cluster_history, got.cluster_history))
    acc = max(abs(a - b) for (_, va), (_, vb) in
              zip(ref.acc_per_cluster, got.acc_per_cluster)
              for a, b in zip(va, vb))
    out = {"bytes_exact": ref.comm.bytes == got.comm.bytes,
           "seconds_exact": ref.comm.seconds == got.comm.seconds,
           "cluster_history_equal": cids, "acc_max_diff": acc,
           "bit_for_bit": cs.run_diff(got, ref)["equal"]}
    ok = (out["bytes_exact"] and out["seconds_exact"] and cids
          and acc <= TOL and ref.comm.rounds == got.comm.rounds)
    if ref_frames is not None:
        norm = max(float(np.max(np.abs(ref_frames[f] - got_frames[f])
                                / np.maximum(np.abs(ref_frames[f]), 1.0)))
                   for f in NORMS)
        counts = all(np.array_equal(ref_frames[f], got_frames[f])
                     for f in ref_frames if f not in NORMS)
        out.update(frame_counts_exact=counts, frame_norm_rel_diff=norm)
        out["bit_for_bit"] = out["bit_for_bit"] and cs.frames_equal(
            ref_frames, got_frames)
        ok = ok and counts and norm <= NORM_TOL
    out["ok"] = bool(ok)
    return out


def k1_at_rank_shape(rows: int) -> dict:
    """K1 at the shape a rank's step 2c gives it (``rows`` nodes of
    ``chip_smoke.MAIN_SHAPE``, as the path makes its inputs) against its
    plain version, timed beside it and its bound (CUDA graphs)."""
    shape = (rows,) + cs.MAIN_SHAPE[1:]
    feats, heads, labels = cs.hs_case(*shape, torch.float32, seed=7)
    feats[..., -1] = 1.0
    labels = labels.abs()
    got = head_losses(feats, heads, labels)
    torch.cuda.synchronize()
    out = cs.hs_check("head_select", got,
                      head_losses_ref(feats, heads, labels),
                      shape=list(shape), dtype="float32")
    bound_ms, bound_by, _, _ = cs.hs_bound(feats, heads, labels)
    out.update(
        ms=cs.graph_ms(lambda: head_losses(feats, heads, labels)),
        plain_ms=cs.graph_ms(lambda: head_losses_ref(feats, heads, labels)),
        bound_ms=bound_ms, bound_by=bound_by)
    return out


def row_block_arithmetic(cfg, ds, rows: int, dev) -> dict:
    """Whether the first ``rows`` nodes computed as a block (a rank's
    share) give what they give inside the batch of all n nodes, on this
    card, under ``run_experiment``'s numerics (TF32 off, deterministic
    cuDNN): each node's loss on its first batch, H local SGD steps (the
    grouped convolutions at ``rows`` groups against n) and the gossip
    contraction (the rows of the mixing matrix against all of it), on
    ``dev``. The largest absolute difference of each; 0.0 where bit for
    bit."""
    n = ds.n_nodes
    binding = make_binding(cfg)
    draws = TorchDraws(0)
    params = algo_program("el", binding, n, cs.PAPER["k"],
                          degree=cs.PAPER["degree"],
                          lr=cs.PAPER["lr"]).setup(draws, dev).state.params
    train_x, train_y = pipeline.place(ds, dev)
    idx = draws.batch_indices(n, cs.PAPER["local_steps"],
                              cs.PAPER["batch_size"], train_x.shape[1])
    batches = pipeline.sample_round_batches(idx.to(dev), train_x, train_y)
    w = topology.mixing_matrix(topology.random_regular(
        draws.perms(n, cs.PAPER["degree"]).to(dev), n, cs.PAPER["degree"]))

    def head(tree):
        return tree_map(lambda l: l[:rows], tree)

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in
                   zip(cs.tree_leaves(a), cs.tree_leaves(b)))

    with device_mod.no_tf32(), device_mod.deterministic(), torch.no_grad():
        first = {k: v[:, 0] for k, v in batches.items()}
        out = {"loss": diff(binding.node_losses(params, first)[:rows],
                            binding.node_losses(head(params), head(first)))}
        out["gossip"] = diff(head(gossip_mix(w, params)), tree_map(
            lambda p: node_matmul(w[:rows], p), params))
    with device_mod.no_tf32(), device_mod.deterministic():
        out["local_sgd"] = diff(
            head(local_sgd(binding, params, batches, cs.PAPER["lr"])),
            local_sgd(binding, head(params), head(batches), cs.PAPER["lr"]))
    return out


def summary(res) -> dict:
    """What every rank's run must agree on, as plain values."""
    return {"acc": res.acc_per_cluster, "bytes": res.comm.bytes,
            "seconds": res.comm.seconds,
            "cids": [c.tolist() for _, c in res.cluster_history],
            "models": [float(l.double().sum()) for l in
                       cs.tree_leaves(res.models)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "chiprun_out" / "mesh_run.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mesh_run: CUDA is not available")
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                            timeout=datetime.timedelta(seconds=600))
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if rank == 0:
        print(smi, flush=True)
    build.build("head_select")
    ds = cs.paper_lenet_data({})
    cfg = cs.lenet()
    mesh = (world,)
    k1 = k1_at_rank_shape(ds.n_nodes // world)
    kw = dict(cs.PAPER, rounds=cs.ROUNDS, eval_every=cs.EVAL_EVERY,
              head_jitter=HEAD_JITTER, device="cuda")
    full = NetworkConfig.preset("edge-v2", faults=cs.MESH_FAULTS)
    rec = {"nvidia_smi": smi, "world": world, "torch": torch.__version__,
           "cuda": torch.version.cuda, "parity": {}, "k1_launches": {}}
    ok = True
    if rank == 0:
        rec["row_block_arithmetic"] = row_block_arithmetic(
            cfg, ds, ds.n_nodes // world, torch.device("cuda", local))
        print(json.dumps({"row_block_arithmetic":
                          rec["row_block_arithmetic"]}), flush=True)
    for algo in ALGOS:
        for variant in ("plain", "full"):
            extra = {} if variant == "plain" else {"net": full}
            obs = None if variant == "plain" else Obs(ObsConfig())
            with cs.counted() as counts:
                got = run_experiment(algo, cfg, ds, mesh=mesh, obs=obs,
                                     **extra, **kw)
                torch.cuda.synchronize()
            ranks = [None] * world
            dist.all_gather_object(ranks, summary(got))
            same = all(r == ranks[0] for r in ranks)
            every = [None] * world
            dist.all_gather_object(every, counts["head_losses"])
            if rank == 0:
                ref_obs = None if obs is None else Obs(ObsConfig())
                ref = run_experiment(algo, cfg, ds, obs=ref_obs, **extra,
                                     **kw)
                res = compare(ref, got,
                              None if obs is None else ref_obs.frames_table(),
                              None if obs is None else obs.frames_table())
                res["ranks_agree"] = same
                res["k1_launches_by_rank"] = every
                want = (cs.ROUNDS + cs.WARMUP_ROUNDS
                        if algo == "facade" else 0)
                res["ok"] = res["ok"] and same and all(
                    c == want for c in every)
                rec["parity"][f"{algo} {variant}"] = res
                print(json.dumps({f"{algo} {variant}": res}), flush=True)
                ok = ok and res["ok"]
            dist.barrier()
    # FACADE's steady rate, meshed (every rank) and mesh=None (rank 0)
    rate_kw = dict(cs.PAPER, rounds=cs.NET_RATE_ROUNDS,
                   eval_every=cs.NET_RATE_ROUNDS, head_jitter=HEAD_JITTER)
    meshed, single = EngineCache(), EngineCache()
    run_experiment("facade", cfg, ds, cache=meshed, device="cuda",
                   mesh=mesh, **rate_kw)
    if rank == 0:
        run_experiment("facade", cfg, ds, cache=single, device="cuda",
                       **rate_kw)
    dist.barrier()
    rates = {"mesh": [], "none": []}
    peaks, single_peaks = [], []
    for rep in range(args.reps):
        _, wall, peak, _ = cs.timed_run("facade", cfg, ds, cache=meshed,
                                        mesh=mesh, **dict(rate_kw, seed=1))
        rates["mesh"].append(cs.NET_RATE_ROUNDS / wall)
        peaks.append(peak)
        if rank == 0:
            _, wall, peak, _ = cs.timed_run("facade", cfg, ds, cache=single,
                                            **dict(rate_kw, seed=1))
            rates["none"].append(cs.NET_RATE_ROUNDS / wall)
            single_peaks.append(peak)
        dist.barrier()
    every = [None] * world
    dist.all_gather_object(every, max(peaks))
    # one replayed meshed segment under the profiler, on every rank
    entry = meshed.entry(dataclasses.replace(
        cs.paper_spec("facade", cfg, ds), mesh=mesh,
        head_jitter=HEAD_JITTER))
    draws = TorchDraws(2)
    carry = entry.engine.init_carry(entry.setup(draws).state)
    train_x, train_y = entry.engine.place_data(ds)
    seg = cs.NET_RATE_ROUNDS
    with cs.counted() as counts:
        prof = cs.device_profile(lambda: entry.engine.run_segment(
            carry, 0, seg, train_x, train_y, draws),
            kernels=(cs.NCCL_KERNEL, cs.K1_KERNEL))
    nccl_events, nccl_s = prof["kernels"][cs.NCCL_KERNEL]
    prof["nccl_share_of_busy"] = (None if not prof["device_busy_s"]
                                  else nccl_s / prof["device_busy_s"])
    prof["nccl_us_per_round"] = 1e6 * nccl_s / seg
    prof["launches"] = counts
    profs = [None] * world
    dist.all_gather_object(profs, prof)
    k1_checks = [None] * world
    dist.all_gather_object(k1_checks, k1)
    if rank == 0:
        rec["rates"] = {
            name: {"median": statistics.median(r), "rates": r}
            for name, r in rates.items()}
        rec["rates"]["mesh_vs_none"] = (rec["rates"]["mesh"]["median"]
                                        / rec["rates"]["none"]["median"])
        rec["peak_allocated_by_rank"] = every
        rec["peak_allocated_one_card"] = max(single_peaks)
        rec["segment_profile_by_rank"] = profs
        rec["k1_at_rank_shape"] = k1_checks
        k1 = [p["kernels"][cs.K1_KERNEL][0] for p in profs]
        rec["k1_launches"] = {"per_rank_per_round": [c / seg for c in k1],
                              "by_counter": [p["launches"]["head_losses"]
                                             for p in profs]}
        ok = ok and all(c == seg for c in k1)
        rec["ok"] = ok
        text = json.dumps(rec, indent=1)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
        print(json.dumps({k: rec[k] for k in (
            "rates", "k1_launches", "peak_allocated_by_rank",
            "peak_allocated_one_card", "ok")}), flush=True)
    del meshed, single, entry, carry
    gc.collect()
    torch.cuda.synchronize()
    dist.barrier()
    return 0 if ok else 1


def shut_down(code: int):
    """Take the process group down and exit with ``code``. NCCL's teardown
    is given 60 s (it waited past any such bound on four cards once the
    round's graphs had captured its all-gathers), then the process exits
    all the same: a rank never outlives the run."""
    t = threading.Thread(target=dist.destroy_process_group, daemon=True)
    t.start()
    t.join(timeout=60)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    shut_down(main())
