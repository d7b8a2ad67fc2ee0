"""Parameter, batch, cache and optimizer partition rules (the counterpart of
``repro.launch.shardings``).

One generic rule engine covers every architecture: a leaf's path is
matched against patterns that name a *preferred* layout; every axis
placement is checked against the mesh for divisibility and dropped (or
moved) when it does not divide, so odd head counts (minicpm3's 40 heads)
or odd vocabularies (73,448) degrade instead of failing.

Layout (MaxText-style 2D), as the reference's:
  * ``model`` axis — tensor parallel: column-parallel in-projections
    (wq/wk/wv/w_gate/w_up, the MoE expert axis when it divides),
    row-parallel out-projections (wo/w_down).
  * ``data`` axis — the batch of activations; with ``fsdp=True`` also the
    largest remaining dim of every big weight (ZeRO-3).
  * the leading ``layers`` axis and FACADE's ``node`` axis are never
    model-sharded; the node axis maps to ``pod``.

A *spec* is a tuple with one entry per tensor dim: ``None``, an axis
name, or a tuple of names (one dim split over several axes, major
first) — what the reference's ``PartitionSpec`` holds, so the two compare
entry for entry. The rules read only the mesh's axis sizes
(:func:`axis_sizes`: a ``DeviceMesh``'s named dims, or any object whose
``shape`` is a dict of them). :func:`placements` turns a spec into
DTensor placements (``Shard(d)`` on every mesh dim a tensor dim names,
``Replicate()`` elsewhere) and :func:`distribute` lays a tree of tensors
out by a tree of specs, which stands for the reference's ``named`` and
``jit(in_shardings=)``.
"""
from __future__ import annotations

import math
import re

import torch
from torch.utils import _pytree as pytree

# pattern -> layout over the TRAILING dims (applied right-aligned).
# "col": last dim on model; "row": second-to-last dim on model;
# "expert": dim -3 on model (MoE stacks), falling back to "col".
_RULES = [
    (r"(^|/)moe/router$", "rep"),
    (r"(^|/)moe/w_(gate|up)$", "expert_col"),
    (r"(^|/)moe/w_down$", "expert_row"),
    (r"(^|/)(attn|self_attn|cross_attn)/wo$", "row"),
    (r"(^|/)(attn|self_attn|cross_attn)/w", "col"),
    (r"(^|/)(mlp|shared|channel_mix|time_mix)/w_(down|out|v)$", "row"),
    (r"(^|/)(mlp|shared|channel_mix|time_mix)/w", "col"),
    (r"(^|/)ssm/w_(in|xproj)$", "col"),
    (r"(^|/)ssm/w_out$", "row"),
    (r"(^|/)embed$", "col"),       # [V, D] -> shard D
    (r"(^|/)lm_head$", "col"),     # [D, V] -> shard V
    (r"(^|/)pos_embed$", "rep"),
]

_BIG_LEAF = 1 << 20  # fsdp only bothers with leaves > 1M elements


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mesh-like object
    whose ``shape`` is such a dict (the tests' ``FakeMesh``)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _path_str(path) -> str:
    parts = []
    for pp in path:
        if hasattr(pp, "key"):
            parts.append(str(pp.key))
        elif hasattr(pp, "idx"):
            parts.append(str(pp.idx))
    return "/".join(parts)


def _map_with_path(fn, tree):
    """``fn(path string, leaf)`` over every tensor-like leaf of ``tree``
    (nested dicts, tuples, named tuples); other leaves (counters, None)
    pass through."""
    return pytree.tree_map_with_path(
        lambda path, leaf: fn(_path_str(path), leaf)
        if hasattr(leaf, "shape") else leaf, tree)


def _divisible(shape, dim, size) -> bool:
    return 0 <= dim < len(shape) and shape[dim] % size == 0 and \
        shape[dim] >= size


def leaf_spec(path_str: str, shape, mesh, *, fsdp: bool = True,
              skip_leading: int = 0, extra_leading: tuple = ()) -> tuple:
    """Partition spec of one leaf. ``skip_leading`` protects stacked axes
    (the layers); ``extra_leading`` are specs for those axes (for example
    node -> 'pod')."""
    axes = axis_sizes(mesh)
    shape = tuple(shape)
    ndim = len(shape)
    model = axes.get("model", 1)
    data = axes.get("data", 1)
    spec: list = [None] * ndim
    for i, ax in enumerate(extra_leading):
        if ax is not None and _divisible(shape, i, axes.get(ax, 1)):
            spec[i] = ax

    layout = "rep"
    for pat, lay in _RULES:
        if re.search(pat, path_str):
            layout = lay
            break

    lo = skip_leading + len(extra_leading)

    def place_model(dim):
        if _divisible(shape, dim, model) and spec[dim] is None:
            spec[dim] = "model"
            return True
        return False

    if layout in ("col", "expert_col"):
        if layout == "expert_col" and ndim - 3 >= lo and _divisible(
                shape, ndim - 3, model):
            spec[ndim - 3] = "model"        # expert parallelism
        elif not place_model(ndim - 1):
            place_model(ndim - 2)
    elif layout in ("row", "expert_row"):
        if layout == "expert_row" and ndim - 3 >= lo and _divisible(
                shape, ndim - 3, model):
            spec[ndim - 3] = "model"
        elif ndim - 2 >= lo and not place_model(ndim - 2):
            place_model(ndim - 1)

    if fsdp and data > 1 and math.prod(shape) > _BIG_LEAF:
        # ZeRO-3: the largest remaining dim over (pod,)data; an axis
        # already placed (the FACADE node dim's 'pod') is left out, since
        # a mesh axis may appear at most once in a spec
        used = {a for sp in spec if sp is not None
                for a in (sp if isinstance(sp, tuple) else (sp,))}
        fs_axes = tuple(a for a in ("pod", "data")
                        if axes.get(a, 1) > 1 and a not in used)
        fs_size = math.prod(axes[a] for a in fs_axes)
        cands = sorted(range(lo, ndim), key=lambda d: -shape[d])
        for d in cands:
            if spec[d] is None and _divisible(shape, d, fs_size):
                spec[d] = fs_axes if len(fs_axes) > 1 else fs_axes[0]
                break
        else:  # data only, when the pod product does not divide
            for d in cands:
                if spec[d] is None and _divisible(shape, d, data):
                    spec[d] = "data"
                    break
    return tuple(spec)


def param_specs(params, mesh, *, fsdp: bool = True,
                node_axis: bool = False):
    """Tree of specs for a (possibly node-stacked) parameter tree.

    ``node_axis=True``: the leading dim of every leaf is FACADE's node
    axis (-> 'pod' where the mesh has it)."""
    extra = (("pod" if "pod" in axis_sizes(mesh) else None),) \
        if node_axis else ()

    def assign(ps, leaf):
        skip = 1 if re.search(r"(^|/)layers(/|$)", ps) else 0
        return leaf_spec(ps, leaf.shape, mesh, fsdp=fsdp,
                         skip_leading=skip, extra_leading=extra)

    return _map_with_path(assign, params)


def batch_specs(batch, mesh, *, node_axis: bool = False):
    """Activations: the batch dim on ('pod', 'data') [plain] or the node
    dim on 'pod' and the batch on 'data' [FACADE]. The first dim the data
    axes divide takes them; nothing divides -> replicated."""
    axes = axis_sizes(mesh)
    data_axes = []
    if not node_axis and "pod" in axes:
        data_axes.append("pod")
    data_axes.append("data")
    dsize = math.prod(axes.get(a, 1) for a in data_axes)

    def assign(_, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        i = 0
        if node_axis:
            if "pod" in axes and _divisible(shape, 0, axes["pod"]):
                spec[0] = "pod"
            i = 1
        for d in range(i, len(shape)):
            if _divisible(shape, d, dsize):
                spec[d] = tuple(data_axes) if len(data_axes) > 1 \
                    else data_axes[0]
                break
        return tuple(spec)

    return _map_with_path(assign, batch)


def cache_specs(cache, mesh):
    """KV caches: the batch on 'data' where it divides, else the slot dim
    (long_500k's batch 1); kv heads on 'model' where they divide, else the
    slot dim takes 'model' (a sequence-sharded cache)."""
    axes = axis_sizes(mesh)
    data = axes.get("data", 1)
    model = axes.get("model", 1)

    def assign(_, leaf):
        shape = tuple(leaf.shape)  # [L, B, slots, ...] or [L, B, ...]
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and _divisible(shape, 1, data):
            spec[1] = "data"
        elif len(shape) >= 3 and _divisible(shape, 2, data):
            spec[2] = "data"
        if len(shape) >= 5 and _divisible(shape, 3, model):
            spec[3] = "model"
        elif (len(shape) >= 4 and spec[2] is None
                and _divisible(shape, 2, model)):
            spec[2] = "model"
        return tuple(spec)

    return _map_with_path(assign, cache)


def opt_specs(opt_state, pspecs):
    """Optimizer slots mirror the parameter specs; the counter is
    replicated (``()``)."""
    return {k: (() if k == "count" else pspecs) for k in opt_state}


def node_carry_specs(carry, n: int):
    """Specs of a segment engine's ``EngineCarry`` (or any node-stacked
    tree) over the 1-D ``node`` mesh, by the port's layout rule
    (:func:`repro_torch.core.meshctx.node_spec`): a leaf whose leading dim
    is ``n`` -> ``('node', None, ...)``, anything else ``()``."""
    from torch.distributed.tensor import Shard

    from repro_torch.core import meshctx

    def assign(_, leaf):
        if isinstance(meshctx.node_spec(leaf, n), Shard):
            return (meshctx.NODE_AXIS,) + (None,) * (leaf.dim() - 1)
        return ()

    return _map_with_path(assign, carry)


# --------------------------------------------------------------------------
def is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        s is None or isinstance(s, (str, tuple)) for s in x)


def placements(spec, mesh) -> tuple:
    """A spec -> DTensor placements over ``mesh`` (a ``DeviceMesh``): each
    mesh dim named by tensor dim d is ``Shard(d)`` (a dim named with a
    tuple of axes is split over them in the mesh's order), every other
    mesh dim ``Replicate()``. A mesh dim of size 1 splits nothing and is
    ``Replicate()`` whatever the spec names, as a size-1 axis of the
    reference's ``PartitionSpec`` is (DTensor would otherwise refuse to
    view away a size-1 dim sharded over it: MoE's one dispatch group on a
    (data 1, model 4) mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dims = [d for d, s in enumerate(spec) if s == name or (
            isinstance(s, tuple) and name in s)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's shard of a ``shape`` tensor laid out by
    ``spec`` (every placement divides, as the rules make sure)."""
    axes = axis_sizes(mesh)
    out = list(shape)
    for d, s in enumerate(spec):
        for a in (s if isinstance(s, tuple) else (s,) if s else ()):
            out[d] //= axes[a]
    return tuple(out)


def distribute(tree, mesh, specs):
    """Each tensor leaf of ``tree`` as a DTensor over ``mesh`` laid out by
    its spec in ``specs`` (a tree of the same structure). Every rank holds
    the whole leaf (drawn from the same seed), so each keeps its own shard
    and nothing is sent (``src_data_rank=None``). Fake tensors (the dry
    run) are wrapped shard by shard with ``DTensor.from_local``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor) or isinstance(leaf, DTensor):
            return leaf
        pl = placements(spec, mesh)
        if _is_fake(leaf):
            local = leaf.new_empty(local_shape(leaf.shape, spec, mesh))
            return DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=leaf.shape,
                                      stride=leaf.stride())
        return distribute_tensor(leaf, mesh, pl, src_data_rank=None)

    flat, spec_tree = pytree.tree_flatten(specs, is_leaf=is_spec)
    leaves = pytree.tree_leaves(tree)
    if len(flat) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(flat)} specs")
    return pytree.tree_unflatten([one(l, s) for l, s in zip(leaves, flat)],
                                 pytree.tree_structure(tree))


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)
