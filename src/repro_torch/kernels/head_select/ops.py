"""Wrapper of the head-select CUDA kernel (``csrc/head_select.cu``).

``head_losses`` computes, for every node and each of its K candidate
heads, the mean cross-entropy over the node's tokens — FACADE's step 2c,
the function of the TPU kernel ``repro/kernels/head_select``. On CUDA
tensors it launches the kernel (built at first use) and raises on what the
kernel does not take; on CPU tensors it runs the plain version
``head_losses_ref``. The CUDA source has four bodies, and
:func:`body_for` picks one from the shape and dtype (``hs_body`` in the
source gives the same answer):

- ``"tensor_core"``: bf16 with D and V multiples of 8, or with V of at
  least one 256-column vocab tile (a ragged D or V is first copied into a
  padded buffer of the workspace), any T > 0. ``wgmma`` fed by TMA, a tile
  kernel and a merge kernel; bound at an LM's shapes by its products at
  989 TFLOP/s (2.18 ms at n·K 4, T 1024, D 2048, V 128,256);
- ``"fp32_tensor_core"``: fp32 with V of at least one 128-column vocab
  tile and D of at least ``F32_TC_MIN_D``, any T > 0. The products on the
  TF32 tensor cores split 3xTF32 (each value x as big = tf32(x) plus small
  = tf32(x - big), three products a step: small·big, big·small, big·big,
  into the tensor cores' fp32 sum, restarted every 32 rows of D and added
  to nearest into a second), so the function stays fp32's: a first launch
  splits the features into two TF32 planes in the workspace, a ragged V is
  copied into rows of V rounded up to 4 (a head pointer off 16-byte
  alignment is refused otherwise), then a warp-specialised ``wgmma``
  kernel computes the logit tile transposed (the head slab as A from
  registers, split there; the feature planes as B by TMA; 128 tokens × 128
  columns a block), the tensor-core body's fold and merge; bound by its
  three products at 495 TFLOP/s (13.0 ms at n·K 2, T 2048, D 2048, V
  128,256);
- ``"fp32_tiled"``: the other fp32 inputs with V of at least one
  128-column vocab tile, any T > 0. A register-blocked SIMT product (128
  tokens × 128 columns a block, 8 × 8 fp32 FMA chains a thread, no TF32)
  fed by a ``cp.async`` ring, the same fold and merge; bound by its
  products at the fp32 pipes' 67 TFLOP/s (32.1 ms at n·K 2, T 2048, D
  2048, V 128,256), against the heads' 0.63 ms of reads; neither fp32 body
  writes the [T, V] logits;
- ``"fma"``: everything else (the CNN paths' step 2c: fp32, D 513 or 65,
  V 10 or 41), one launch.

The tiled bodies take a workspace this wrapper allocates in one piece.
``head_losses.launches`` counts calls that launched the kernel (one per
call, whichever body ran); a profile tells the bodies apart by their
kernels' names (``head_losses_kernel``, ``head_losses_f32_kernel``,
``head_losses_lm_kernel``, ``head_losses_f32tc_kernel``, with
``head_losses_lm_merge`` after every tiled body,
``head_losses_tf32_split_kernel`` before the fp32 tensor-core body's and
``head_losses_pad_kernel`` before the tensor cores' ragged calls).

On DTensors each rank scores its own nodes (``local_map``): the node dim
may stay sharded, while a node's tokens, features, heads and vocabulary
are gathered whole first (a node's loss is a mean over all its tokens
and a log-sum-exp over the whole vocabulary); the counter counts each
rank's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import localmap
from repro_torch.kernels import build

from .ref import head_losses_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bodies in the order of the source's codes
BODIES = ("fma", "fp32_tiled", "tensor_core", "fp32_tensor_core")
# csrc/head_select.cu: kLmBV (the tensor cores' vocab tile), kF32MinV and
# kF32TcMinD
TC_MIN_RAGGED_V = 256
F32_MIN_V = 128
F32_TC_MIN_D = 192


def body_for(n: int, k: int, t: int, d: int, v: int, dtype) -> str:
    """The body the kernel runs for features [n, T, D] and heads
    [n, K, D, V] of ``dtype`` (the source's ``body_for``)."""
    del n, k                                     # the rule reads no count
    if t <= 0 or d <= 0 or v <= 0:
        return "fma"
    if dtype == torch.bfloat16 and ((d % 8 == 0 and v % 8 == 0)
                                    or v >= TC_MIN_RAGGED_V):
        return "tensor_core"
    if dtype == torch.float32 and v >= F32_MIN_V:
        return "fp32_tensor_core" if d >= F32_TC_MIN_D else "fp32_tiled"
    return "fma"


def _takes(body: str, t: int, d: int, v: int, dtype) -> bool:
    if body == "fma":
        return True
    if min(t, d, v) <= 0:
        return False
    return {"fp32_tiled": torch.float32, "tensor_core": torch.bfloat16,
            "fp32_tensor_core": torch.float32}[body] == dtype


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("head_select")
    lib.hs_head_losses_for.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    lib.hs_head_losses_for.restype = ctypes.c_int
    lib.hs_workspace_bytes_for.argtypes = [ctypes.c_int] * 7
    lib.hs_workspace_bytes_for.restype = ctypes.c_longlong
    lib.hs_body.argtypes = [ctypes.c_int] * 6
    lib.hs_body.restype = ctypes.c_int
    lib.hs_pad_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    lib.hs_pad_rows.restype = ctypes.c_int
    lib.hs_error_string.argtypes = [ctypes.c_int]
    lib.hs_error_string.restype = ctypes.c_char_p
    return lib


def head_losses(features, heads, labels, *, body: str | None = None
                ) -> torch.Tensor:
    """features [n, T, D], heads [n, K, D, V], labels [n, T] int32 (< 0:
    excluded; else < V) -> [n, K] fp32 mean NLL, denominator
    ``max(valid, 1)``. Features and heads are fp32 or bf16, one dtype.
    ``body`` runs one of :data:`BODIES` in place of :func:`body_for`'s
    (for timing one body against another; raises where it cannot take
    the input)."""
    if features.dim() != 3 or heads.dim() != 4 or labels.dim() != 2:
        raise ValueError("expected features [n,T,D], heads [n,K,D,V], "
                         "labels [n,T]")
    n, t, d = features.shape
    if heads.shape[0] != n or heads.shape[2] != d or \
            tuple(labels.shape) != (n, t):
        raise ValueError(
            f"shape mismatch: features {tuple(features.shape)}, heads "
            f"{tuple(heads.shape)}, labels {tuple(labels.shape)}")
    if body is not None and body not in BODIES:
        raise ValueError(f"unknown body {body!r}; one of {BODIES}")
    if localmap.any_dtensor(features, heads, labels):
        return _on_mesh(features, heads, labels, body)
    devices = {features.device, heads.device, labels.device}
    if devices == {torch.device("cpu")}:
        return head_losses_ref(features, heads, labels)
    if len(devices) != 1 or features.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: "
                         f"{sorted(map(str, devices))}")
    if features.dtype not in _DTYPES or heads.dtype != features.dtype:
        raise TypeError(f"features/heads must share fp32 or bf16, got "
                        f"{features.dtype}/{heads.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if not (features.is_contiguous() and heads.is_contiguous()
            and labels.is_contiguous()):
        raise ValueError("features, heads and labels must be contiguous")
    k, v = heads.shape[1], heads.shape[3]
    if body is None:
        body = body_for(n, k, t, d, v, features.dtype)
    elif not _takes(body, t, d, v, features.dtype):
        raise ValueError(f"body {body!r} does not take {features.dtype} at "
                         f"T {t}, D {d}, V {v}")
    out = torch.empty((n, k), dtype=torch.float32, device=features.device)
    if out.numel() == 0:
        return out
    lib = _library()
    dtype, code = _DTYPES[features.dtype], BODIES.index(body)
    with torch.cuda.device(features.device):
        nbytes = lib.hs_workspace_bytes_for(code, n, k, t, d, v, dtype)
        if nbytes < 0:
            raise RuntimeError("head_select: the card's occupancy query "
                               "failed")
        ws = torch.empty(nbytes // 4, dtype=torch.float32,
                         device=features.device) if nbytes else None
        rc = lib.hs_head_losses_for(
            code, features.data_ptr(), heads.data_ptr(), labels.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), n, k, t,
            d, v, dtype, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("head_select kernel launch failed: "
                           + lib.hs_error_string(rc).decode())
    head_losses.launches += 1
    return out


head_losses.launches = 0


def _on_mesh(features, heads, labels, body):
    """:func:`head_losses` of DTensors on each rank's nodes (module
    docstring)."""
    lm = localmap
    ref = next(x for x in (features, heads, labels) if lm.is_dtensor(x))
    ref = lm.settle(ref, (0,), "head_losses input")
    f, h, lab = (lm.like(x, ref, {0: 0}) for x in (features, heads,
                                                   labels))
    kw = {} if body is None else {"body": body}
    return lm.on_shards(
        lambda fl, hl, ll: head_losses(fl.contiguous(), hl.contiguous(),
                                       ll.contiguous(), **kw),
        (f, h, lab), tuple(f.placements))
