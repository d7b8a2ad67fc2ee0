"""The hardware the port's roofline divides by (the counterpart of
``repro.launch.mesh``'s ``HW``), and the node mesh.

One NVIDIA H100 SXM, from NVIDIA's H100 data sheet (the figures
``PERF.md`` §6 cites for the kernels' bounds). Of the reference's mesh
builders, :func:`make_node_mesh` is here: FACADE's node axis split over
cards, one process per card (``run_experiment(mesh=...)``,
``SegmentEngine(mesh=...)``, :mod:`repro_torch.core.meshctx`). The
production and debug meshes (``make_production_mesh``,
``make_debug_mesh``), which shard a language model's data and model axes
for the dry run, are not ported yet: the port's steps and dry run run on
one card.
"""
from __future__ import annotations

HW = {
    # NVIDIA H100 SXM, per card
    "peak_flops_bf16": 989e12,   # FLOP/s, dense bf16 on the tensor cores
    "peak_flops_fp32": 67e12,    # FLOP/s, fp32 outside the tensor cores
    "hbm_bw": 3.35e12,           # bytes/s, HBM3
    "nvlink_bw": 900e9,          # bytes/s per card, NVLink 4 (unused on
                                 # one card)
}

# the mesh label of the port's records: one card
MESH_NAME = "h100x1"


def make_node_mesh(n_devices: int | None = None, device="cuda"):
    """1-D ``node`` mesh for the sharded segment engine: a
    ``DeviceMesh`` named ``("node",)`` over the default process group, one
    rank per card. ``n_devices=None`` takes the world size of the
    initialised group (1 when there is none, and then a one-rank group is
    started, as :func:`repro_torch.core.meshctx.build` says). On the card
    unless ``device="cpu"`` asks for gloo's CPU mesh. More than one rank
    needs the group started first, for example by ``torchrun
    --nproc-per-node P``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import meshctx

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but CUDA is not available; "
                           "pass device='cpu' for a CPU mesh")
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return meshctx.build((int(n_devices),), dev.type)
