"""Node-axis mesh plumbing for the sharded segment engine, the port of
``repro.core.meshctx``.

The reference runs one controller over a 1-D ``node`` device mesh: the
carry's node-stacked leaves are row-sharded, and ``shard_map`` turns the
cross-node contractions into row blocks over all-gathered senders.
PyTorch's idiom is one process per card (``torch.distributed``: NCCL on
the card, gloo on the CPU), each rank running the same
``run_experiment`` call (SPMD) on its own block of ``n / P`` nodes:

* the canonical mesh description is a SHAPE tuple like ``(4,)``
  (:func:`normalize`), which is what ``EngineSpec`` keys on and what a
  checkpoint's fingerprint holds; :func:`build` turns it into a live 1-D
  ``DeviceMesh`` named ``("node",)`` over the default process group;
* the layout rule (:func:`node_spec`): a node-stacked leaf (leading dim
  ``n``) is ``Shard(0)``, each rank holding the contiguous rows
  ``[r * n/P, (r + 1) * n/P)`` (:func:`local_rows`); anything else is
  ``Replicate()``;
* the round's small ``[n]`` and ``[n, n]`` tensors (the adjacency and
  mixing matrix, the netsim masks, the channel, the gossip ages, the
  crash chain, the topology policy's EWMAs and DAC's similarity table)
  are computed whole on every rank from the same draws. That stands in
  for the reference's ``constrain_rows``, which row-shards them: at the
  paper's 32 nodes they are a few KB, and computing them whole keeps
  every cross-node sum (bytes, seconds, the frame's counts) in
  ``mesh=None``'s order;
* the round's context (:func:`activate` / :func:`current`): the engine
  runs (and on CUDA captures) its rounds inside ``activate(mesh)``, and
  the round closures consult :func:`current` to take their rows of the
  whole tensors (:func:`rows`) and to gather what the neighbours send
  (:func:`gather_tree`: one ``all_gather_into_tensor`` for a whole tree);
* a product or per-row reduction over the rank's rows runs at
  ``mesh=None``'s shape (:func:`pad_rows`, then :func:`rows_of`): the
  kernels (a cuBLAS GEMM's tiling, a reduction's split) follow the shape,
  and at another shape a row sums in another order. With it, the rank's
  rows are ``mesh=None``'s bit for bit wherever the per-node work is.
  ``mesh=None`` never activates a context, and every helper here returns
  its input unchanged without one.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_unflatten

NODE_AXIS = "node"

_ACTIVE: list = []   # run-time stack; [-1] is the mesh the rounds run on


def normalize(mesh):
    """Canonicalize a user-facing ``mesh=`` argument to the shape tuple the
    cache keys on: ``None`` | int | 1-tuple | 1-D ``DeviceMesh`` -> ``None``
    or ``(P,)``. Meshes of several axes are refused: the engine shards
    exactly one axis (the node axis)."""
    if mesh is None:
        return None
    if hasattr(mesh, "mesh_dim_names"):            # a DeviceMesh
        shape = tuple(int(s) for s in mesh.shape)
    elif isinstance(mesh, int):
        shape = (int(mesh),)
    else:
        shape = tuple(int(s) for s in mesh)
    if len(shape) != 1:
        raise ValueError(
            f"mesh shape {shape} has {len(shape)} axes; the segment engine "
            "shards exactly one axis (the node axis): pass an int, a "
            "1-tuple like (4,), or a 1-D DeviceMesh")
    if shape[0] < 1:
        raise ValueError(f"mesh needs at least 1 device, got {shape[0]}")
    return shape


def build(shape, device_type: str = "cuda"):
    """Shape tuple -> live 1-D node ``DeviceMesh`` over the default process
    group (``None`` passes through, a ``DeviceMesh`` too).

    ``(1,)`` with no process group yet starts a one-rank group itself
    (gloo on the CPU, NCCL on the card), its rendezvous a ``FileStore``
    under a fresh temp directory, so a single process needs no launcher.
    ``(P,)`` with ``P > 1`` needs an initialised group of world size
    ``P``: one process per card, started by ``torchrun`` or spawned, each
    having called ``init_process_group`` (on the card after
    ``torch.cuda.set_device``)."""
    if shape is None or hasattr(shape, "mesh_dim_names"):
        return shape
    from torch.distributed.device_mesh import init_device_mesh

    (size,) = normalize(shape)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"node mesh ({size},) needs {size} devices, have no "
                "process group: start one process per card (torchrun "
                f"--nproc-per-node {size} ...) and call "
                "torch.distributed.init_process_group in each")
        store = dist.FileStore(
            os.path.join(tempfile.mkdtemp(prefix="node-mesh-"), "store"), 1)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", store=store,
            rank=0, world_size=1)
    world = dist.get_world_size()
    if world != size:
        raise RuntimeError(
            f"node mesh ({size},) needs {size} devices, have {world} (the "
            f"ranks of the process group): start it with torchrun "
            f"--nproc-per-node {size} (or spawn {size} ranks)")
    return init_device_mesh(device_type, (size,),
                            mesh_dim_names=(NODE_AXIS,))


@contextlib.contextmanager
def activate(mesh):
    """While active, the round closures take their rows of the whole
    round tensors and gather the senders over ``mesh``. ``None`` is a
    true no-op."""
    if mesh is None:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current():
    """The mesh the rounds run on, or ``None`` outside any context."""
    return _ACTIVE[-1] if _ACTIVE else None


def node_spec(t, n: int):
    """The layout rule: leading dim == ``n`` -> ``Shard(0)``, rows on the
    node axis; anything else (scalars, odd shapes) ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    shape = getattr(t, "shape", ())
    if len(shape) >= 1 and shape[0] == n:
        return Shard(0)
    return Replicate()


def block(mesh, n: int) -> tuple[int, int]:
    """``(lo, m)``: the first of the rank's ``m = n / P`` rows."""
    size, rank = mesh.size(), mesh.get_local_rank(0)
    if n % size:
        raise ValueError(f"a mesh of {size} ranks must divide n={n} nodes")
    m = n // size
    return rank * m, m


def local_rows(t, mesh, n: int):
    """The rank's rows of a whole node-leading ``t`` ``[n, ...]``."""
    lo, m = block(mesh, n)
    return t[lo:lo + m]


def gather_rows(t, mesh):
    """Every rank's block of rows ``[m, ...]`` -> the whole ``[P * m,
    ...]``, in rank order: one ``all_gather_into_tensor``."""
    t = t.contiguous()
    out = torch.empty((mesh.size() * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=mesh.get_group(0))
    return out


def rows(t):
    """Under an active mesh the rank's rows of the whole ``t`` (its
    leading dim the node count); ``t`` itself otherwise."""
    mesh = current()
    if mesh is None:
        return t
    return local_rows(t, mesh, t.shape[0])


def pad_rows(t, n: int):
    """The rank's rows ``t`` ``[m, ...]`` of an ``n``-row tensor, placed at
    their rows of a zero ``[n, ...]`` tensor (``t`` itself without a mesh
    or at ``m == n``). A product or a per-row reduction over it runs at
    ``mesh=None``'s shape, so cuBLAS and the reduction kernels pick
    ``mesh=None``'s kernel and summation order, and the rank's rows of the
    result (:func:`rows`) are ``mesh=None``'s bit for bit: a GEMM's row
    depends on that row and the kernel, never on the other rows."""
    mesh = current()
    if mesh is None or t.shape[0] == n:
        return t
    lo, m = block(mesh, n)
    return torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 1) + (lo, n - lo - m))


def rows_of(t, like):
    """The rank's rows of a whole ``t`` where ``like`` holds a block of
    rows (a product or reduction run over :func:`pad_rows`); ``t`` itself
    where ``like`` is whole or no mesh is active."""
    if current() is None or t.shape[0] == like.shape[0]:
        return t
    return rows(t)


def row_offset(n: int) -> int:
    """The rank's first row of an ``n``-row tensor (0 without a mesh)."""
    mesh = current()
    return 0 if mesh is None else block(mesh, n)[0]


def gather_tree(tree, mesh=None):
    """Every rank's block of each leaf of ``tree`` (nested dicts of
    tensors; ``None`` passes through) -> the whole leaves, in ONE
    collective: each leaf's rows are viewed as bytes and laid side by side
    in a ``[m, total]`` uint8 buffer, which is all-gathered and cut back.
    ``mesh`` defaults to :func:`current`; the identity without one."""
    mesh = current() if mesh is None else mesh
    if mesh is None or tree is None:
        return tree
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    m = leaves[0].shape[0]
    parts = [leaf.contiguous().reshape(m, -1).view(torch.uint8)
             if leaf.numel() else
             torch.empty((m, 0), dtype=torch.uint8, device=leaf.device)
             for leaf in leaves]
    whole = gather_rows(torch.cat(parts, dim=1), mesh)
    out, at = [], 0
    for leaf, part in zip(leaves, parts):
        w = part.shape[1]
        piece = whole[:, at:at + w].contiguous().view(leaf.dtype)
        out.append(piece.reshape((whole.shape[0],) + tuple(leaf.shape[1:])))
        at += w
    return tree_unflatten(tree, out)
