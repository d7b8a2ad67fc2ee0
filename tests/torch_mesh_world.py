"""One rank of a spawned gloo world for ``tests/test_torch_mesh.py``.

``python tests/torch_mesh_world.py RANK WORLD STORE OUT`` joins a world of
``WORLD`` gloo ranks through the file store ``STORE`` (no TCP port, so
worlds of parallel test workers never clash), runs every case of
:func:`cases` with ``mesh=(WORLD,)`` and pickles each run's summary into
``OUT.RANK``. Every rank runs the same calls (SPMD). The settings mirror
the reference's ``tests/test_mesh.py`` (``CFG``, ``KW``, its tiny data),
with ``head_jitter > 0`` so FACADE's head selection stays clear of
last-ulp ties.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys

import numpy as np
import torch

from repro_torch.configs.facade_paper import lenet
from repro_torch.core import engine
from repro_torch.core.runner import run_experiment
from repro_torch.data.synthetic import SynthSpec, make_clustered_data
from repro_torch.netsim import NetworkConfig
from repro_torch.obs import Obs, ObsConfig
from repro_torch.resil import FaultConfig
from repro_torch.topo import TopoConfig
from repro_torch.tree import tree_leaves

CFG = lenet(smoke=True).replace(n_classes=4)
ALGOS = ("facade", "el", "dpsgd", "deprl", "dac")
KW = dict(rounds=4, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=2, seed=0, head_jitter=0.05, device="cpu")
# the kill-and-resume runs: one segment a round, so a pipelined run has
# saved a segment when its third dispatch is refused
RESUME_KW = {**KW, "eval_every": 1}
FULL = dataclasses.replace(
    NetworkConfig.preset("edge-v2"),
    faults=FaultConfig(crash_rate=0.1, restart_rate=0.5, corrupt_rate=0.2,
                       corrupt_mode="nan"))
# what a run adds on top of KW: "full" is the reference's stack (edge-v2's
# async gossip and bursty channel, NaN corruption, telemetry); "reset"
# restarts crashed nodes from their round-0 state and corrupts by noise
# (its draws are node-stacked); "topo" samples the graph by an adaptive
# policy on a tiered network
VARIANTS = {
    "plain": {},
    "full": {"net": FULL},
    "reset": {"net": NetworkConfig.preset("edge-v2", faults=FaultConfig(
        crash_rate=0.3, restart_rate=0.5, restart_mode="reset",
        corrupt_rate=0.3))},
    "topo": {"net": NetworkConfig.preset("core-edge"),
             "topo": TopoConfig(policy="reliability", decay=0.7,
                                min_inclusion=0.25)}}
TIMEOUT_S = 90


def data(sizes=(6, 2)):
    """The reference's tiny clustered data; ``(3, 1)`` is its 4-node set,
    ``(6, 2)`` the 8 nodes its multi-device check runs."""
    spec = SynthSpec(n_classes=4, image_size=16, samples_per_class=8,
                     test_per_class=8, seed=3)
    return make_clustered_data(spec, cluster_sizes=sizes,
                               transforms=("rot0", "rot180"))


def summary(res, obs=None) -> dict:
    """A run as plain numpy and Python values."""
    out = {"acc": res.acc_per_cluster, "fair": res.fair_acc,
           "dp": res.dp, "eo": res.eo, "final": res.final_acc,
           "rounds": list(res.comm.rounds), "bytes": list(res.comm.bytes),
           "seconds": list(res.comm.seconds),
           "evaled": list(res.comm.evaled),
           "cids": [(r, np.asarray(c)) for r, c in res.cluster_history],
           "models": [l.detach().cpu().numpy()
                      for l in tree_leaves(res.models)]}
    if obs is not None:
        out["frames"] = {k: np.asarray(v)
                         for k, v in obs.run_frames_table().items()}
    return out


def run(algo, variant, ds, mesh=None, **kw):
    """One run of ``algo`` under ``VARIANTS[variant]``, observed by an
    ``Obs`` unless it is "plain"."""
    args = {**KW, **VARIANTS[variant], **kw}
    obs = None
    if variant != "plain":
        obs = args["obs"] = Obs(config=ObsConfig())
    return summary(run_experiment(algo, CFG, ds, mesh=mesh, **args), obs)


class Killed(Exception):
    pass


def killed_then_resumed(algo, ds, world, path, pipeline):
    """``algo`` under the full stack, killed at its third dispatch (one
    segment saved; on the pipelined driver the second segment ran too),
    then resumed from ``path`` by the same call."""
    def call():
        obs = Obs(config=ObsConfig())
        res = run_experiment(algo, CFG, ds, mesh=(world,), net=FULL,
                             obs=obs, ckpt=path, pipeline=pipeline,
                             **RESUME_KW)
        return summary(res, obs)

    real, calls = engine.SegmentEngine.dispatch_segment, [0]

    def killer(self, *a, **k):
        calls[0] += 1
        if calls[0] == 3:
            raise Killed
        return real(self, *a, **k)

    engine.SegmentEngine.dispatch_segment = killer
    try:
        call()
        raise AssertionError("the run was not killed")
    except Killed:
        pass
    finally:
        engine.SegmentEngine.dispatch_segment = real
    return call()


def cases(world: int, tmp: str) -> dict:
    """Every case a world of ``world`` ranks runs, by name."""
    ds = data()
    got = {}
    for algo in ALGOS:
        for variant in VARIANTS:
            got[(algo, variant)] = run(algo, variant, ds, mesh=(world,))
    if world == 2:
        for algo, pipeline in (("facade", True), ("dac", False)):
            obs = Obs(config=ObsConfig())
            got[("whole", algo)] = summary(run_experiment(
                algo, CFG, ds, mesh=(world,), net=FULL, obs=obs,
                pipeline=pipeline, **RESUME_KW), obs)
            got[("resumed", algo)] = killed_then_resumed(
                algo, ds, world, os.path.join(tmp, f"{algo}.ckpt.npz"),
                pipeline)
        from torch_caps import JaxDraws
        got[("jax", "facade")] = summary(run_experiment(
            "facade", CFG, ds, mesh=(world,), draws=JaxDraws(KW["seed"]),
            **KW))
    return got


def main(rank: int, world: int, store: str, out: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        got = cases(world, os.path.dirname(out))
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
