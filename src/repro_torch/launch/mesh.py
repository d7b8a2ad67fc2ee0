"""The hardware the port's roofline divides by (the counterpart of
``repro.launch.mesh``'s ``HW``).

One NVIDIA H100 SXM, from NVIDIA's H100 data sheet (the figures
``PERF.md`` §6 cites for the kernels' bounds). The mesh builders of the
reference (``make_production_mesh``, ``make_debug_mesh``,
``make_node_mesh``) are not here: they shard across devices, and the
port's steps and dry run run on one card.
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
