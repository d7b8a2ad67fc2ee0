"""Wrapper of the head-select CUDA kernel (``csrc/head_select.cu``).

``head_losses`` computes, for every node and each of its K candidate
heads, the mean cross-entropy over the node's tokens — FACADE's step 2c,
the function of the TPU kernel ``repro/kernels/head_select``. On CUDA
tensors it launches the kernel (built at first use) and raises on what the
kernel does not take; on CPU tensors it runs the plain version
``head_losses_ref``. The CUDA source picks one of two bodies from the
shape: the LM regime (bf16 with D and V multiples of 8, any T > 0) runs
on the tensor cores as two device launches with a workspace this wrapper
allocates; every other input runs on the FMA body as one. ``head_losses.launches`` counts calls that launched the kernel
(one per call, whichever body ran).

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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("head_select")
    lib.hs_head_losses.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.hs_head_losses.restype = ctypes.c_int
    lib.hs_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.hs_workspace_bytes.restype = ctypes.c_longlong
    lib.hs_error_string.argtypes = [ctypes.c_int]
    lib.hs_error_string.restype = ctypes.c_char_p
    return lib


def head_losses(features, heads, labels) -> torch.Tensor:
    """features [n, T, D], heads [n, K, D, V], labels [n, T] int32 (< 0:
    excluded; else < V) -> [n, K] fp32 mean NLL, denominator
    ``max(valid, 1)``. Features and heads are fp32 or bf16, one dtype."""
    if features.dim() != 3 or heads.dim() != 4 or labels.dim() != 2:
        raise ValueError("expected features [n,T,D], heads [n,K,D,V], "
                         "labels [n,T]")
    n, t, d = features.shape
    if heads.shape[0] != n or heads.shape[2] != d or \
            tuple(labels.shape) != (n, t):
        raise ValueError(
            f"shape mismatch: features {tuple(features.shape)}, heads "
            f"{tuple(heads.shape)}, labels {tuple(labels.shape)}")
    if localmap.any_dtensor(features, heads, labels):
        return _on_mesh(features, heads, labels)
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
    out = torch.empty((n, k), dtype=torch.float32, device=features.device)
    if out.numel() == 0:
        return out
    lib = _library()
    dtype = _DTYPES[features.dtype]
    with torch.cuda.device(features.device):
        nbytes = lib.hs_workspace_bytes(n, k, t, d, v, dtype)
        if nbytes < 0:
            raise RuntimeError("head_select: the card's occupancy query "
                               "failed")
        ws = torch.empty(nbytes // 4, dtype=torch.float32,
                         device=features.device) if nbytes else None
        rc = lib.hs_head_losses(
            features.data_ptr(), heads.data_ptr(), labels.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), n, k, t,
            d, v, dtype, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("head_select kernel launch failed: "
                           + lib.hs_error_string(rc).decode())
    head_losses.launches += 1
    return out


head_losses.launches = 0


def _on_mesh(features, heads, labels):
    """:func:`head_losses` of DTensors on each rank's nodes (module
    docstring)."""
    lm = localmap
    ref = next(x for x in (features, heads, labels) if lm.is_dtensor(x))
    ref = lm.settle(ref, (0,), "head_losses input")
    f, h, lab = (lm.like(x, ref, {0: 0}) for x in (features, heads,
                                                   labels))
    return lm.on_shards(
        lambda fl, hl, ll: head_losses(fl.contiguous(), hl.contiguous(),
                                       ll.contiguous()),
        (f, h, lab), tuple(f.placements))
