"""One rank of a spawned gloo world for ``tests/test_torch_lm_mesh.py``.

``python tests/torch_lm_mesh_world.py RANK WORLD STORE OUT [REF_IN]``
joins a world of ``WORLD`` gloo ranks through the file store ``STORE``
(no TCP port), builds a ``(2, WORLD // 2)`` ``("data", "model")`` debug
mesh on the CPU and runs every case of :data:`CASES` through
``launch.steps.build_case`` twice: on the mesh and with ``mesh=None``
(every rank the whole step), in fp32 from the same seed. It pickles, per
case, both outputs gathered whole (``full_tensor``; one list of arrays an
output of the step) into ``OUT.RANK``, with the K2 and K3 launch counts
(0 on the CPU) and the placements of the prefill's logits.

With ``REF_IN`` (a pickle: each arch's reference parameters as numpy
trees and each case's other arguments) every case also runs on the mesh
from those arguments, its parameters carried across by
``interop.lm_params_from_jax`` and every leaf that a dim of divides
FSDP-sharded (the size floor lowered to 0, as the reference's run it is
held against); its outputs are kept as numpy trees (``"ref_mesh"``).
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import sys

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv6 import wkv
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.base import get_config

# (arch, input shape, batch): the smoke configs in fp32, S cut by cfg
CASES = (("llama3.2-1b", "prefill_32k", 4), ("llama3.2-1b", "decode_32k", 4),
         ("llama3.2-1b", "train_4k", 4), ("rwkv6-1.6b", "prefill_32k", 4))
SEQ = 16
TIMEOUT_S = 120


def smoke(arch: str):
    return get_config(arch, smoke=True).replace(dtype="float32")


def _whole(tree) -> list:
    """Every tensor leaf of ``tree`` (nested dicts, tuples) as a whole
    numpy array, in order; counters and other scalars are left out."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _whole(v)]
    if isinstance(tree, (tuple, list)):
        return [a for v in tree for a in _whole(v)]
    if isinstance(tree, DTensor):
        return [tree.full_tensor().detach().numpy()]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    return []


def _tree_np(tree):
    """``tree`` with every tensor as a whole numpy array, its dicts and
    sequences kept (tuples as lists); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_tree_np(v) for v in tree]
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return tree


def run_ref_case(arch, shape, batch, mesh, params, rest, cfg=None,
                 seq=SEQ):
    """One step on ``mesh`` from the reference's parameters (numpy) and
    the arguments ``rest`` (numpy trees) -> its outputs as numpy trees
    (``cfg``: default ``arch``'s fp32 smoke config)."""
    from repro_torch.interop import lm_params_from_jax
    from repro_torch.launch import shardings

    case = steps.build_case(arch, shape, device="cpu", seed=0, batch=batch,
                            cfg=smoke(arch) if cfg is None else cfg,
                            seq=seq)
    p = lm_params_from_jax(params)
    tensors = [pytree.tree_map(torch.from_numpy, r)
               for r in rest]
    if case.kind == "train":
        tensors = [steps.make_optimizer(arch, case.cfg).init(p)] + tensors
    floor = shardings._BIG_LEAF
    shardings._BIG_LEAF = 0
    try:
        case = steps._on_mesh(dataclasses.replace(case, args=(p, *tensors)),
                              mesh, fsdp=True, act_sharding=True,
                              seq_model=False)
    finally:
        shardings._BIG_LEAF = floor
    return _tree_np(case.step_fn(*case.args))


def run_case(arch, shape, batch, mesh):
    """One step on ``mesh`` (or ``None``), at sequence :data:`SEQ`."""
    case = steps.build_case(arch, shape, device="cpu", seed=0,
                            batch=batch, cfg=smoke(arch), seq=SEQ,
                            mesh=mesh)
    fa0, wkv0 = flash_attention.launches, wkv.launches
    out = case.step_fn(*case.args)
    got = {"out": [_whole(part) for part in out],
           "launches": (flash_attention.launches - fa0,
                        wkv.launches - wkv0)}
    if case.kind == "prefill" and mesh is not None:
        got["placements"] = [str(p) for p in out[0].placements]
    return got


def cases(world: int, ref=None) -> dict:
    mesh = make_debug_mesh((2, world // 2), ("data", "model"), device="cpu")
    got = {}
    for arch, shape, batch in CASES:
        got[(arch, shape)] = {"mesh": run_case(arch, shape, batch, mesh),
                              "none": run_case(arch, shape, batch, None)}
        if ref is not None:
            got[(arch, shape)]["ref_mesh"] = run_ref_case(
                arch, shape, batch, mesh, ref["params"][arch],
                ref["rest"][(arch, shape)])
    return got


def main(rank: int, world: int, store: str, out: str, ref_in=None):
    import torch.distributed as dist

    ref = None
    if ref_in is not None:
        with open(ref_in, "rb") as f:
            ref = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        got = cases(world, ref)
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         *sys.argv[5:6])
