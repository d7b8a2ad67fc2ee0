"""Roofline terms of one step traced by PyTorch (the counterpart of
``repro.roofline.analysis``, which reads them from a compiled XLA
executable).

Three terms, each a lower-bound time in seconds on the target card
(``launch.mesh.HW``: one NVIDIA H100 SXM)::

    compute    = FLOPs          / peak bf16 FLOP/s
    memory     = bytes          / HBM bytes/s
    collective = collective B   / NVLink bytes/s  (0 on one card)

:func:`count_step` runs the step once, on real tensors or on the fake
tensors of ``FakeTensorMode`` (shapes only, nothing allocated: the dry
run), and reads its cost from the trace:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode``: matmuls,
  convolutions and attention kernels at 2 a multiply-add, elementwise ops
  at 0; a backward pass and a ``torch.utils.checkpoint`` recompute count
  as they run. On CPU tensors the kernels' wrappers run their plain
  versions: the plain attention counts all S² scores where the card's
  kernel (K2) skips the masked tiles, so a causal step counts up to twice
  the kernel's attention work. The sequential loops count through their
  one-op stand-ins (``repro_torch.scan_ops``).
* bytes as the sum of each op's input and output bytes, one op at a time
  (views move nothing and count 0). This is the unfused count: every
  intermediate goes to memory and back, so it is an upper bound on the
  HBM traffic of the step (a fused kernel, or data that stays in cache,
  moves less).
* peak bytes as the step's arguments and outputs (each tensor once), a
  floor on its peak memory: the activations are not counted.

A step on DTensors (a mesh: ``launch.steps.build_case(mesh=...)``) is
counted per card, as the reference's per-device cost analysis of the
partitioned module: the count sees the ops each rank runs on its local
shards (the DTensor-level op is left to DTensor's dispatch, and what that
dispatch runs locally is counted), so FLOPs and bytes are one card's.
Its bytes leave out metadata queries (``prim.device``, which read no
data and which DTensor's dispatch issues in other numbers than the plain
step does): at mesh (1, 1) they are one card's less its
``metadata_bytes``, which one card's count includes. The
collectives DTensor issues (``_c10d_functional`` ops) are summed apart
by :func:`collective_bytes_from_trace`, the counterpart of the
reference's ``collective_bytes_from_hlo``: each one's result bytes under
the reference's names; a collective over a group of one rank moves
nothing and is not counted. A step on plain tensors has none, so its
collective term is 0 and its counts empty, as on one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x,
                                                               torch.Tensor)]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _is_metadata(func) -> bool:
    """A metadata query (``prim.device``): it reads no tensor data."""
    return func.namespace == "prim"


class _OpBytes(TorchDispatchMode):
    """Sums every op's input and output tensor bytes; views count 0. The
    bytes metadata queries add to that sum are also kept apart
    (``meta``)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.meta = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            n = sum(_nbytes(x) for x in _tensors((args, kwargs, out)))
            self.total += n
            if _is_metadata(func):
                self.meta += n
        return out


class StepCost(NamedTuple):
    flops: float        # FlopCounterMode's total (per card on a mesh)
    bytes: float        # each op's inputs and outputs, summed
    peak_bytes: float   # the step's arguments and outputs
    out: Any            # what the step returned
    collectives: tuple = ()   # (reference op name, result bytes) each
    metadata_bytes: float = 0.0   # of ``bytes``, metadata queries' (one
    #                               card; a mesh count leaves them out)


# the reference's collective names of the functional collectives
_COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute")
_C10D_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x):
    return x._local_tensor if _is_dtensor(x) else x


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    return 2 if name is None else _resolve_process_group(name).size()


class _LocalCost(TorchDispatchMode):
    """Counts the ops each rank runs on its local tensors: an op on
    DTensors is left to DTensor's dispatch (``NotImplemented``), which
    runs its local ops, and those come back here. FLOPs by
    ``FlopCounterMode``'s formulas, bytes as :class:`_OpBytes`, and the
    functional collectives apart (their result bytes)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.total = 0
        self.collectives: list = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ns = func.namespace
        if ns == "_c10d_functional":
            # a collective under the reference's name (any other under its
            # own); waits move nothing
            name = _C10D_NAMES.get(func._opname, func._opname)
            if name != "wait_tensor" and _group_size(args) > 1:
                self.collectives.append(
                    (name, sum(_nbytes(x) for x in _tensors(out))))
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view and not _is_metadata(func):
            self.total += sum(_nbytes(x) for x in _tensors((args, kwargs,
                                                            out)))
        return out


@contextlib.contextmanager
def _dtensor_tracing(mode: _LocalCost):
    """Two patches of DTensor's sharding propagation while a step is
    counted. It runs an op once at its global shape to learn its output's
    (on a cache miss): that is not work of the step, so it is not counted.
    And a strided shard (a dim merged from two sharded dims, as
    ``[B, S, D] -> [B*S, D]`` with B and S sharded) computes its shard
    sizes with index tensors, which under the fake tensors of a dry run
    would be fake; they are computed on real ones, once for each
    (placement, size, rank)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    meta = ShardingPropagator._propagate_tensor_meta_non_cached
    sizes = _StridedShard.__dict__["local_shard_size_and_offset"]

    def quiet(self, op_schema):
        mode.paused += 1
        try:
            return meta(self, op_schema)
        finally:
            mode.paused -= 1

    memo: dict = {}

    def real_sizes(self, *args, **kwargs):
        key = (self, args, tuple(sorted(kwargs.items())))
        try:
            hit = memo.get(key)
        except TypeError:               # an unhashable argument: no memo
            key, hit = None, None
        if hit is None:
            with unset_fake_temporarily():
                hit = sizes(self, *args, **kwargs)
            if key is not None:
                memo[key] = hit
        return hit

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    _StridedShard.local_shard_size_and_offset = real_sizes
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = meta
        _StridedShard.local_shard_size_and_offset = sizes


def _on_mesh(tree) -> bool:
    return any(_is_dtensor(x) for x in pytree.tree_leaves(tree))


def count_step(step_fn, args, context=None) -> StepCost:
    """Run ``step_fn(*args)`` once inside ``context`` (the
    ``FakeTensorMode`` the arguments were made in, or None for real
    tensors) and count its cost; on DTensor arguments, one card's."""
    if _on_mesh(args):
        return _count_on_mesh(step_fn, args, context)
    with (context or contextlib.nullcontext()):
        with FlopCounterMode(display=False) as flops, _OpBytes() as nbytes:
            out = step_fn(*args)
    seen = {id(x): x for x in _tensors((args, out))}
    return StepCost(float(flops.get_total_flops()), float(nbytes.total),
                    float(sum(_nbytes(x) for x in seen.values())), out,
                    metadata_bytes=float(nbytes.meta))


def _count_on_mesh(step_fn, args, context) -> StepCost:
    mode = _LocalCost()
    with (context or contextlib.nullcontext()):
        with _dtensor_tracing(mode), mode:
            out = step_fn(*args)
    seen = {id(x): _local(x) for x in _tensors((args, out))}
    return StepCost(float(mode.flops), float(mode.total),
                    float(sum(_nbytes(x) for x in seen.values())), out,
                    tuple(mode.collectives))


def collective_bytes_from_trace(collectives) -> dict:
    """Sum the result bytes of every collective a traced step issued
    (``StepCost.collectives``: (name, bytes) pairs). Returns the
    reference's ``collective_bytes_from_hlo`` layout: ``{op_name: bytes,
    ..., 'total': bytes, 'count': n_ops, 'counts': {op_name: n}}``."""
    out = {op: 0 for op in _COLLECTIVE_OPS}
    counts = {op: 0 for op in _COLLECTIVE_OPS}
    for name, nbytes in collectives:
        out[name] = out.get(name, 0) + nbytes
        counts[name] = counts.get(name, 0) + 1
    return {**out, "total": sum(out.values()),
            "count": sum(counts.values()), "counts": counts}


# --------------------------------------------------------------------------
@dataclasses.dataclass
class RooflineReport:
    """The reference's report; its ``hlo_`` fields (and ``row()`` keys)
    hold the traced step's counts here."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per card
    hlo_bytes: float          # per card, the unfused upper bound
    collective_bytes: float   # per card (0 on one card)
    collective_counts: dict
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float        # 6·N·D useful flops (global)
    bytes_per_device: float   # arguments and outputs

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / the step's counted FLOPs — how much of the
        counted compute is 'useful' model math (remat's recompute and the
        plain attention's masked scores are not)."""
        tot = self.hlo_flops * self.chips
        return self.model_flops / tot if tot else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "hlo_gflops_per_dev": self.hlo_flops / 1e9,
            "hlo_gbytes_per_dev": self.hlo_bytes / 1e9,
            "coll_gbytes_per_dev": self.collective_bytes / 1e9,
            "model_gflops": self.model_flops / 1e9,
            "useful_ratio": self.useful_ratio,
            "peak_gbytes_per_dev": self.bytes_per_device / 1e9,
        }


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """6·N·D for training; 2·N·D for inference fwd-only."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * float(n_params_active) * float(n_tokens)


def analyze_step(cost: StepCost, *, arch: str, shape: str, mesh_name: str,
                 chips: int, hw: dict, n_params_active: int, n_tokens: int,
                 kind: str) -> RooflineReport:
    """The report of a step whose cost :func:`count_step` counted (the
    counterpart of the reference's ``analyze_compiled``). The collective
    term divides one card's collective bytes by ``hw["nvlink_bw"]``."""
    coll = collective_bytes_from_trace(cost.collectives)
    counts = coll["counts"] if coll["count"] else {}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        collective_bytes=float(coll["total"]), collective_counts=counts,
        t_compute=cost.flops / hw["peak_flops_bf16"],
        t_memory=cost.bytes / hw["hbm_bw"],
        t_collective=float(coll["total"]) / hw["nvlink_bw"],
        model_flops=model_flops(n_params_active, n_tokens, kind),
        bytes_per_device=cost.peak_bytes,
    )
