"""Where a function on plain tensors meets DTensors: each rank runs it on
its local shards (``torch.distributed.tensor.experimental.local_map``).

The hand-written kernels (K2, K3), the one-op stand-ins of the sequential
loops (``scan_ops``) and the few ops DTensor has no sharding rule for
(MoE's index assignment, the depthwise conv's ``unfold``) are called
through :func:`on_shards`, each with the layout under which its work
splits into independent per-rank pieces: the batch and the heads (or
channels) may be sharded, the dims it reduces or scans over may not.
:func:`settle` brings an argument to such a layout first: a sharding of a
dim the function cannot split is gathered (``Replicate``), a ``Partial``
sum is reduced, so no rank ever computes on a part of a sequence as if it
were all of it.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.utils import _pytree as pytree


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def any_dtensor(*xs) -> bool:
    return any(is_dtensor(x) for x in xs)


def settle(x, splittable, name: str = "tensor", strict=()):
    """``x`` (a DTensor) redistributed so that every mesh dim is
    ``Replicate`` or ``Shard(d)`` with ``d`` in ``splittable``: a shard of
    another dim is gathered and a ``Partial`` reduced. A shard of a dim in
    ``strict`` raises ``ValueError`` naming the placement instead."""

    nd = x.ndim
    keep = {d % nd for d in splittable}
    strict = {d % nd for d in strict}
    want = []
    for p in x.placements:
        if isinstance(p, Shard) and p.dim % nd in keep:
            want.append(p)
        elif isinstance(p, Shard) and p.dim % nd in strict:
            raise ValueError(
                f"{name}: placement {p} splits a dim the kernel must see "
                f"whole (of shape {tuple(x.shape)}); gather it first")
        else:
            want.append(Replicate())
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(want))


def like(x, ref, dims: dict):
    """``x`` (plain or DTensor) laid out over ``ref``'s mesh with ``ref``'s
    shards of the dims in ``dims`` (ref dim -> x dim) and replicated
    elsewhere."""

    mesh = ref.device_mesh
    want = tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in
                 dims else Replicate() for p in ref.placements)
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def on_shards(fn, args, out_placements):
    """``fn`` on each rank's local shards of ``args`` (DTensors, or
    non-tensors), its outputs wrapped with ``out_placements`` (one
    placement tuple an output; a tuple of them for several outputs)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    in_pl = tuple(list(a.placements) if is_dtensor(a) else None
                  for a in args)
    # local_map reads a tuple as one entry an output, a list as one output
    if isinstance(out_placements[0], Placement):
        out_placements = list(out_placements)
    else:
        out_placements = tuple(list(pl) for pl in out_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=False)(*args)


def mesh_block(x, dim: int):
    """``(index, count)`` of this rank's block of ``x``'s dim ``dim``: the
    mesh dims sharding it, in mesh order (major first), as DTensor splits
    a dim over several mesh dims."""

    idx, count = 0, 1
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            size = x.device_mesh.size(m)
            idx = idx * size + x.device_mesh.get_local_rank(m)
            count *= size
    return idx, count



def whole_seq(x):
    """``x`` ``[B, S, ...]`` with its sequence dim 1 whole where a mesh dim
    shards it (the hooks' ``seq_model`` carry), its other shards kept and
    a ``Partial`` sum reduced; plain tensors and DTensors whose sequence
    is whole pass through. The products and sequence slices that follow
    read the whole sequence, as the reference's GSPMD gathers the
    sequence-parallel carry before its matmuls; the card's DTensor (torch
    2.11) cannot fold a sharded sequence dim into a matmul's rows."""
    if not is_dtensor(x) or mesh_block(x, 1)[1] == 1:
        return x
    return settle(x, [d for d in range(x.ndim) if d != 1])


def split_last(x, *sizes):
    """``x`` with its last dim split into ``sizes`` (heads first), as
    ``x.reshape(*x.shape[:-1], *sizes)``. A DTensor whose last dim is
    sharded more ways than ``sizes[0]`` divides (8 kv heads on a 16-way
    model axis) is gathered along it first."""
    if is_dtensor(x):
        _, count = mesh_block(x, x.ndim - 1)
        if count > 1 and sizes[0] % count:
            x = settle(x, range(x.ndim - 1))
    return x.reshape(*x.shape[:-1], *sizes)


def heads_on_shards(fn, q, k, v, q_rows=(), kv_rows=(), *, name: str,
                    q_seq: bool = False):
    """``fn(q, k, v, *q_rows, *kv_rows)`` — an attention of q ``[B, Sq,
    Hq, D]`` and k, v ``[B, Skv, Hkv, D]`` (query head h reads kv head
    ``h // (Hq/Hkv)``), with per-row tensors ``q_rows`` ``[B, Sq, ...]``
    and ``kv_rows`` ``[B, Skv, ...]`` — on each rank's batch rows and
    query heads; the output keeps q's placements. q may stay sharded
    along Sq where ``q_seq`` (the rows then carry their positions), is
    gathered along it otherwise, and raises on a shard of D. k and v take
    q's head shards where their heads divide as q's do; otherwise each
    rank keeps them whole and takes the kv heads its query heads read.
    Their Skv is always whole (the softmax runs over it)."""
    if not is_dtensor(q):
        q = like(q, next(x for x in (k, v) if is_dtensor(x)), {})
    q = settle(q, (0, 2, 1) if q_seq else (0, 2), f"{name} q", strict=(3,))
    g = q.shape[2] // k.shape[2]
    idx, count = mesh_block(q, 2)
    split_kv = k.shape[2] % count == 0
    dims = {0: 0, 2: 2} if split_kv else {0: 0}
    k, v = (like(x, q, dims) for x in (k, v))
    q_rows = [like(r, q, {0: 0, 1: 1}) for r in q_rows]
    kv_rows = [like(r, q, {0: 0}) for r in kv_rows]

    def local_fn(ql, kl, vl, *rows):
        if not split_kv:                    # whole kv: this rank's heads
            hl = ql.shape[2]
            if hl % g and g % hl:
                raise ValueError(
                    f"{name}: {hl} local query heads of groups of {g} "
                    "cannot share whole kv heads")
            lo, hi = idx * hl // g, ((idx + 1) * hl - 1) // g + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl, *rows)

    return on_shards(local_fn, (q, k, v, *q_rows, *kv_rows),
                     tuple(q.placements))


def merge_last(x, n: int = 2):
    """``x`` with its last ``n`` dims merged into one (heads first), as
    ``x.reshape(*x.shape[:-n], -1)``. A DTensor is reshaped as it is only
    where its first merged dim is split into whole, equal parts; otherwise
    (heads replicated, 56 heads on a 16-way axis, a shard of a later
    merged dim) it is reshaped on each rank's shards with the merged dims
    whole, so that the backward pass gathers a gradient sharded along the
    merged dim (a row-parallel product's) before splitting it back."""
    if is_dtensor(x):
        lead = x.ndim - n
        _, count = mesh_block(x, lead)
        later = any(mesh_block(x, d)[1] > 1 for d in range(lead + 1, x.ndim))
        if later or count == 1 or x.shape[lead] % count:
            x = settle(x, range(lead))
            return on_shards(lambda t: t.reshape(*t.shape[:lead], -1), (x,),
                             tuple(x.placements))
    return x.reshape(*x.shape[:-n], -1)


def lookup(table, idx):
    """``table[idx]`` (an embedding's rows ``[V, D]`` at integer ``idx``).
    On DTensors each rank looks its rows up in its shard of the table
    gathered whole along V; the output has ``idx``'s shards and the
    table's shards of D. The backward is each rank's own index-put into a
    zero table of its D shard, handed back as a partial sum over the mesh
    dims that shard ``idx`` (:class:`_Lookup`): a tied embedding's two
    gradients (the lookup's and the head's product) then add as partial
    sums, and no rule of DTensor for ``index_put`` is asked for."""

    if not any_dtensor(table, idx):
        return table[idx]
    if not is_dtensor(table):
        table = like(table, idx, {})
    whole = settle(table.detach(), (1,), "embedding table")
    idx = like(idx, whole, {}) if not is_dtensor(idx) else idx
    idx = settle(idx, range(idx.ndim), "embedding indices")
    # a mesh dim sharding the table's D leaves the indices whole there
    taken = [isinstance(p, Shard) for p in whole.placements]
    want = tuple(Replicate() if t else p
                 for p, t in zip(idx.placements, taken))
    if want != tuple(idx.placements):
        idx = idx.redistribute(idx.device_mesh, want)
    out_pl = tuple(Shard(idx.ndim) if t else p
                   for p, t in zip(idx.placements, taken))
    grad_pl = tuple(Partial() if isinstance(p, Shard) else q
                    for p, q in zip(idx.placements, whole.placements))
    return _Lookup.apply(table, whole, idx, out_pl, grad_pl)


class _Lookup(torch.autograd.Function):
    """:func:`lookup`'s rows and their gradient, rank by rank."""

    @staticmethod
    def forward(ctx, table, whole, idx, out_pl, grad_pl):
    
        il = idx.to_local()
        ctx.save_for_backward(il)
        ctx.meta = (whole.device_mesh, tuple(whole.to_local().shape),
                    tuple(table.shape), out_pl, grad_pl)
        ctx.table_pl = tuple(table.placements)
        rows = whole.to_local()[il]
        shape = tuple(idx.shape) + (table.shape[1],)
        return DTensor.from_local(rows, whole.device_mesh, out_pl,
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))

    @staticmethod
    def backward(ctx, grad):
    
        (il,) = ctx.saved_tensors
        mesh, local_shape, shape, out_pl, grad_pl = ctx.meta
        if tuple(grad.placements) != out_pl:
            grad = grad.redistribute(mesh, out_pl)
        g = grad.to_local()
        # the ops of a plain tensor's indexing backward (autograd's
        # index_backward: the unchecked index-put on real tensors, the
        # checked one on fake tensors), so the rows add in its order
        from torch._subclasses.fake_tensor import FakeTensor
        zeros = g.new_zeros(local_shape)
        if isinstance(g, FakeTensor):
            gt = zeros.index_put((il,), g, accumulate=True)
        else:
            gt = torch.ops.aten._unsafe_index_put(zeros, [il], g, True)
        gt = DTensor.from_local(gt, mesh, grad_pl, run_check=False,
                                shape=shape,
                                stride=_contiguous_stride(shape))
        # in the table's own layout (a partial sum reduce-scattered), as
        # its other uses' gradients come (a tied head's)
        if tuple(gt.placements) != ctx.table_pl:
            gt = gt.redistribute(mesh, ctx.table_pl)
        return gt, None, None, None, None


def per_node(fn, *trees):
    """``fn(*trees)``, a computation independent per node on trees whose
    tensors lead with the node axis. Where that axis of a DTensor lies on
    mesh dims ('pod': FACADE's nodes across pods), each rank runs ``fn``
    on its own nodes only: every leaf becomes a DTensor of the rank's
    nodes over the remaining mesh dims (its shards there kept), and the
    results are laid back over the whole mesh with the node axis on those
    dims. Otherwise (plain tensors, nodes replicated) ``fn(*trees)``."""

    leaves, spec = pytree.tree_flatten(trees)
    ref = next((x for x in leaves if is_dtensor(x)), None)
    if ref is None:
        return fn(*trees)
    mesh = ref.device_mesh
    node_dims = [m for m, p in enumerate(ref.placements)
                 if isinstance(p, Shard) and p.dim == 0]
    if not node_dims:
        return fn(*trees)
    names = mesh.mesh_dim_names
    rest = [m for m in range(mesh.ndim) if m not in node_dims]
    sub = mesh[tuple(names[m] for m in rest)] if rest else None

    def down(x):
        if not isinstance(x, torch.Tensor):
            return x
        if not is_dtensor(x):
            x = like(x, ref, {0: 0})
        want = tuple(Shard(0) if m in node_dims else p
                     for m, p in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(mesh, want)
        local = x.to_local()
        if sub is None:
            return local
        return DTensor.from_local(
            local, sub, [x.placements[m] for m in rest], run_check=False,
            shape=(local.shape[0],) + tuple(x.shape[1:]),
            stride=_contiguous_stride((local.shape[0],) + tuple(x.shape[1:])))

    outs = fn(*pytree.tree_unflatten([down(x) for x in leaves], spec))
    count = 1
    for m in node_dims:
        count *= mesh.size(m)

    def up(y):
        if not isinstance(y, torch.Tensor):
            return y
        local = y.to_local() if is_dtensor(y) else y
        sub_pl = list(y.placements) if is_dtensor(y) else []
        it = iter(sub_pl)
        pl = [Shard(0) if m in node_dims else
              (next(it) if sub_pl else Replicate()) for m in
              range(mesh.ndim)]
        shape = (y.shape[0] * count,) + tuple(y.shape[1:])
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=shape,
                                  stride=_contiguous_stride(shape))

    return pytree.tree_map(up, outs)


def local(x):
    """A DTensor's local shard; a plain tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def new_stack(x, n: int):
    """An empty ``[n, *x.shape]`` tensor laid out as ``x`` is (a leading
    dim, whole, before its own): ``n`` of ``x`` to be copied in through
    :func:`local`."""
    if not is_dtensor(x):
        return x.new_empty((n,) + tuple(x.shape))
    loc = x.to_local()
    shape = (n,) + tuple(x.shape)
    pl = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
               for p in x.placements)
    return DTensor.from_local(loc.new_empty((n,) + tuple(loc.shape)),
                              x.device_mesh, pl, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def grad_in_layout(x):
    """``x`` itself, whose gradient is handed back in ``x``'s own layout
    (a partial sum reduced or reduce-scattered there). A leaf used twice,
    as a tied embedding is (its rows looked up, its transpose the head),
    then gets two gradients of one layout to add: DTensor would otherwise
    be left to add a partial sum to a shard, which some of its versions
    plan as a redistribution they cannot run. On a mesh of one rank there
    is one layout, and ``x`` is returned as it is (another node in the
    graph would change the order in which autograd adds ``x``'s
    gradients, and so their last bits)."""
    if not is_dtensor(x) or x.device_mesh.size() == 1:
        return x
    return _InLayout.apply(x)


class _InLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # a partial sum's gradient is the same on every rank: replicated
        ctx.layout = (x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, placements = ctx.layout
        if is_dtensor(grad) and tuple(grad.placements) != placements:
            grad = grad.redistribute(mesh, placements)
        return grad


DATA_AXES = ("pod", "data")


def gather_fsdp(tree):
    """Each DTensor leaf of ``tree`` (a layer's parameters) gathered along
    the data axes, where FSDP shards it (``launch.shardings``' ZeRO-3
    dims), keeping its model-axis shards: the products then run as the
    reference's GSPMD runs them after its all-gather, an activation's
    gradient comes out in one layout whichever weight it went through, and
    each weight's gradient is reduce-scattered back to its shards. Plain
    tensors pass through."""

    def one(x):
        if not is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names or ()
        want = tuple(Replicate() if isinstance(p, Shard) and
                     names[m] in DATA_AXES else p
                     for m, p in enumerate(x.placements))
        if want == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, want)

    return pytree.tree_map(one, tree)
