"""The hardware the port's roofline divides by (the counterpart of
``repro.launch.mesh``'s ``HW``) and the meshes (its mesh builders).

One NVIDIA H100 SXM, from NVIDIA's H100 data sheet (the figures
``PERF.md`` §6 cites for the kernels' bounds). ``nvlink_bw`` is NVLink
4's total per card (18 links, both directions); the roofline's collective
term divides a card's collective bytes by it. A 16-way model axis spans
two 8-card NVLink domains, whose link between them is slower, so there
the term is a lower bound.

The meshes are ``DeviceMesh``es over the default process group, one rank
per card (NCCL on the card, gloo on the CPU), built with
``init_device_mesh``:

* :func:`make_production_mesh` — the reference's ``(data 16, model 16)``
  and ``(pod 2, data 16, model 16)``, with its axis names, so every spec
  of ``launch.shardings`` is the reference's and the records keep its
  mesh names (:data:`PROD_MESH_NAMES`);
* :func:`make_debug_mesh` — a small mesh of any shape (tests, four cards);
* :func:`make_node_mesh` — FACADE's node axis split over cards
  (``run_experiment(mesh=...)``, :mod:`repro_torch.core.meshctx`);
* :func:`fake_world` — a world of any size in one process on
  ``torch.distributed``'s ``"fake"`` backend (collectives do nothing), on
  which the dry run traces the production meshes on fake tensors, as the
  reference forces 512 host devices.
"""
from __future__ import annotations

import contextlib
import math

HW = {
    # NVIDIA H100 SXM, per card
    "peak_flops_bf16": 989e12,   # FLOP/s, dense bf16 on the tensor cores
    "peak_flops_fp32": 67e12,    # FLOP/s, fp32 outside the tensor cores
    "hbm_bw": 3.35e12,           # bytes/s, HBM3
    "nvlink_bw": 900e9,          # bytes/s per card, NVLink 4's total
}

# the mesh label of the port's records: one card
MESH_NAME = "h100x1"
# the production meshes' labels, the reference's
PROD_MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}


def _build(shape, axes, device):
    """``init_device_mesh`` over the default group, which must hold
    ``prod(shape)`` ranks (a ``DeviceMesh`` spans the world). A mesh of
    one rank with no group yet starts a one-rank group itself, as
    :func:`repro_torch.core.meshctx.build` does."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import meshctx

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    need = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but CUDA is not available; "
                           "pass device='cpu' for a CPU mesh")
    if need == 1 and not dist.is_initialized():
        meshctx.build((1,), dev.type)          # starts the one-rank group
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, have {have} (the ranks of "
            "the process group): start one process per card (torchrun "
            f"--nproc-per-node {need}), or trace it on fake_world({need})")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """single pod: (data=16, model=16) = 256 ranks;
    multi-pod:  (pod=2, data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes, device)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), device="cuda"):
    """A small mesh for tests and a few cards (on the CPU: ``device=
    "cpu"``, over gloo or the fake world)."""
    return _build(shape, axes, device)


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of ``size`` ranks in this one process (this
    is rank 0), on the ``"fake"`` backend: meshes build and DTensor ops
    trace, and collectives return without communicating. Destroyed on
    exit, so nothing after it sees a process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(size))
    try:
        yield
    finally:
        dist.destroy_process_group()


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
