"""Roofline terms of one step traced by PyTorch (the counterpart of
``repro.roofline.analysis``, which reads them from a compiled XLA
executable).

Three terms, each a lower-bound time in seconds on the target card
(``launch.mesh.HW``: one NVIDIA H100 SXM)::

    compute    = FLOPs          / peak bf16 FLOP/s
    memory     = bytes          / HBM bytes/s
    collective = collective B   / link bytes/s   (0: one card)

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

The reference's ``collective_bytes_from_hlo`` is not ported: there is no
HLO to read, and on one card no collective runs, so the collective term
is 0 and its counts empty.
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


class _OpBytes(TorchDispatchMode):
    """Sums every op's input and output tensor bytes; views count 0."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(_nbytes(x) for x in _tensors((args, kwargs,
                                                            out)))
        return out


class StepCost(NamedTuple):
    flops: float        # FlopCounterMode's total
    bytes: float        # each op's inputs and outputs, summed
    peak_bytes: float   # the step's arguments and outputs
    out: Any            # what the step returned


def count_step(step_fn, args, context=None) -> StepCost:
    """Run ``step_fn(*args)`` once inside ``context`` (the
    ``FakeTensorMode`` the arguments were made in, or None for real
    tensors) and count its cost."""
    with (context or contextlib.nullcontext()):
        with FlopCounterMode(display=False) as flops, _OpBytes() as nbytes:
            out = step_fn(*args)
    seen = {id(x): x for x in _tensors((args, out))}
    return StepCost(float(flops.get_total_flops()), float(nbytes.total),
                    float(sum(_nbytes(x) for x in seen.values())), out)


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
    counterpart of the reference's ``analyze_compiled``)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        collective_bytes=0.0, collective_counts={},
        t_compute=cost.flops / hw["peak_flops_bf16"],
        t_memory=cost.bytes / hw["hbm_bw"],
        t_collective=0.0,
        model_flops=model_flops(n_params_active, n_tokens, kind),
        bytes_per_device=cost.peak_bytes,
    )
