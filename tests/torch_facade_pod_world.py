"""One rank of a spawned gloo world for ``tests/test_torch_facade_pod.py``.

``python tests/torch_facade_pod_world.py RANK WORLD STORE OUT IN`` joins
a world of ``WORLD`` (4) gloo ranks through the file store ``STORE`` and
runs FACADE's step of llama3.2-1b's fp32 smoke config, built by
``launch.steps.build_facade_case``, from the state, batches and topology
draw pickled in ``IN`` (the reference's initial state, carried across):
with ``mesh=None``, on the multi-pod layout (pod 2, data 1, model 2),
where each pod's ranks run their own node, and on (data 2, model 2)
without 'pod', where every rank holds both nodes. It pickles, per run,
the new state and the round's info gathered whole into ``OUT.RANK``,
with what step 2c's kernel saw: the shape of each call's local features
and K1's launch count (0 on the CPU).
"""
from __future__ import annotations

import datetime
import pickle
import sys

import torch

from repro_torch.core import facade as facade_mod
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import init_facade_state
from repro_torch.kernels.head_select import head_losses
from repro_torch.kernels.head_select import ops as hs_ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from torch_lm_mesh_world import _tree_np, smoke

ARCH = "llama3.2-1b"
# the reference case's values (n 2, k 2, degree 1, lr 1e-3) but the cuts
N, K, BATCH, SEQ, LOCAL_STEPS = 2, 2, 2, 16, 1
MESHES = {"pod": ((2, 1, 2), ("pod", "data", "model")),
          "data_model": ((2, 2), ("data", "model"))}
TIMEOUT_S = 120


def _record_k1_calls(calls: list):
    """Wrap ``head_losses`` where the round calls it and where its DTensor
    branch calls it on each rank's shards, so that each call on plain
    tensors appends its features' shape to ``calls``; returns the undo."""
    inner = hs_ops.head_losses

    def spy(features, heads, labels):
        if not hasattr(features, "device_mesh"):
            calls.append(tuple(features.shape))
        return inner(features, heads, labels)

    hs_ops.head_losses = facade_mod.head_losses = spy

    def undo():
        hs_ops.head_losses = facade_mod.head_losses = inner

    return undo


def run(inp: dict, mesh=None) -> dict:
    """FACADE's step from ``inp``'s state, batches and draw on ``mesh``
    (or one device): its outputs as whole numpy trees."""
    cfg = smoke(ARCH)
    case = steps.build_facade_case(
        ARCH, n_nodes=N, k=K, batch_per_node=BATCH, seq=SEQ,
        local_steps=LOCAL_STEPS, device="cpu", seed=0, cfg=cfg, mesh=mesh)
    state = init_facade_state(make_binding(cfg), N, K,
                              params=inp["params"], heads_k=inp["heads_k"],
                              device="cpu")
    batches = inp["batches"]
    if mesh is not None:
        state, batches = steps._facade_on_mesh(state, batches, mesh)
    calls: list = []
    undo = _record_k1_calls(calls)
    k1 = head_losses.launches
    try:
        new, info = case.step_fn(state, batches, inp["perms"])
    finally:
        undo()
    got = {"cores": _tree_np(new.cores), "heads": _tree_np(new.heads),
           "cluster_id": _tree_np(new.cluster_id), "round": new.round,
           "info": {key: _tree_np(info[key]) for key in
                    ("selection_losses", "cluster_id", "round_bytes")},
           "k1_calls": calls, "launches": head_losses.launches - k1}
    if mesh is not None:
        got["placements"] = {
            key: [str(p) for p in x.placements] for key, x in
            (("cluster_id", new.cluster_id),
             ("selection_losses", info["selection_losses"]),
             ("lm_head", new.heads["lm_head"]))}
    return got


def main(rank: int, world: int, store: str, out: str, inp_path: str):
    import torch.distributed as dist

    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        got = {"none": run(inp)}
        for name, (shape, axes) in MESHES.items():
            got[name] = run(inp, make_debug_mesh(shape, axes, device="cpu"))
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
