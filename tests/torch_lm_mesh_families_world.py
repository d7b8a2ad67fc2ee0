"""One rank of a spawned gloo world for
``tests/test_torch_lm_mesh_families.py``.

``python tests/torch_lm_mesh_families_world.py RANK WORLD STORE OUT
REF_PARAMS`` joins a world of ``WORLD`` (4) gloo ranks through the file store
``STORE`` and runs every case of :data:`CASES` — the smoke prefill and
decode of the hybrid, MoE, MLA, VLM and audio families in fp32, each on
its (data, model) debug mesh — twice on the mesh: built by
``launch.steps.build_case(mesh=...)`` from the port's own draw (held
against ``mesh=None`` from the same seed, run once for each config and
shape), and then from the reference's parameters, which the reference's
process writes to ``REF_PARAMS`` (a pickle of numpy trees, one a config)
while the first runs go on, with every
leaf that a dim of divides FSDP-sharded (held against the reference's
step on the same mesh). It pickles, per case, the outputs gathered whole
into ``OUT.RANK``, with K2's launch count (0 on the CPU).
"""
from __future__ import annotations

import datetime
import pickle
import sys

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.base import get_config
from torch_lm_mesh_world import _whole, run_ref_case

# a config name -> (the arch whose smoke config it is, fields changed):
# hymba with full-width hymba-1.5b's shape of heads (25 query heads over 5
# kv heads) cut to 5 over 1, so neither the query nor the kv heads divide
# a model axis of 2
VARIANTS = {"hymba-1.5b-h5": ("hymba-1.5b", dict(n_heads=5, n_kv_heads=1,
                                                 head_dim=32))}
PREFIX = {"llava-next-34b"}          # S holds the image prefix as well
SEQ = 16
BATCH = 4
SHAPES = ("prefill_32k", "decode_32k")
# (config name, mesh shape): each run at both shapes. On (2, 2) every
# smoke config's heads divide the model axis but the variant's; on
# (1, 4) hymba's and llava's 2 kv heads do not, and MoE's tokens form one
# dispatch group (two on (2, 2))
RUNS = (("hymba-1.5b", (2, 2)), ("deepseek-moe-16b", (2, 2)),
        ("minicpm3-4b", (2, 2)), ("llava-next-34b", (2, 2)),
        ("whisper-tiny", (2, 2)), ("hymba-1.5b-h5", (2, 2)),
        ("hymba-1.5b", (1, 4)), ("llava-next-34b", (1, 4)),
        ("deepseek-moe-16b", (1, 4)))
CASES = tuple((name, shape, mesh) for name, mesh in RUNS for shape in SHAPES)
TIMEOUT_S = 120


def arch_of(name: str) -> str:
    return VARIANTS[name][0] if name in VARIANTS else name


def config(name: str):
    """The fp32 smoke config of a config name (a variant's fields
    changed)."""
    cfg = get_config(arch_of(name), smoke=True).replace(dtype="float32")
    if name in VARIANTS:
        cfg = cfg.replace(name=name, **VARIANTS[name][1])
    return cfg


def seq_of(name: str) -> int:
    cfg = config(name)
    return SEQ + (cfg.n_image_tokens if arch_of(name) in PREFIX else 0)


def build(name, shape, mesh=None):
    return steps.build_case(arch_of(name), shape, device="cpu", seed=0,
                            batch=BATCH, cfg=config(name), seq=seq_of(name),
                            mesh=mesh)


def run(name, shape, mesh=None) -> dict:
    case = build(name, shape, mesh)
    fa0 = flash_attention.launches
    out = case.step_fn(*case.args)
    return {"out": [_whole(part) for part in out],
            "launches": flash_attention.launches - fa0}


def cases(world: int, ref_params: str) -> dict:
    from torch_lm_mesh_world import _tree_np
    from torch_worlds import wait_for

    meshes = {shape: make_debug_mesh(shape, ("data", "model"), device="cpu")
              for shape in sorted({m for _, _, m in CASES})}
    assert all(m.size() == world for m in meshes.values())
    got = {}
    for name, shape, mesh_shape in CASES:
        if (name, shape) not in got:
            got[(name, shape)] = run(name, shape)
        got[(name, shape, mesh_shape)] = {
            "mesh": run(name, shape, meshes[mesh_shape])}
    params = wait_for(ref_params)
    for name, shape, mesh_shape in CASES:
        rest = [_tree_np(r) for r in build(name, shape).args[1:]]
        got[(name, shape, mesh_shape)]["ref_mesh"] = run_ref_case(
            arch_of(name), shape, BATCH, meshes[mesh_shape], params[name],
            rest, cfg=config(name), seq=seq_of(name))
    return got


def main(rank: int, world: int, store: str, out: str, ref_params: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        got = cases(world, ref_params)
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
