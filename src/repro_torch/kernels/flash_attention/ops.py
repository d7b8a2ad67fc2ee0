"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention`` computes causal (optionally sliding-window) GQA
attention over a full sequence at positions ``arange(S)`` — the function
of the TPU kernel ``repro/kernels/flash_attention`` — in the model's layout
``[B, S, H, D]``, so the kernel reads the projections where they lie, with
no transposition. On CUDA tensors it launches the kernel (built at first
use) and raises on what the kernel does not take; on CPU tensors it runs
the plain version ``attention_ref``. bf16 inputs go to the tensor-core
kernel (``mma.sync``, with P V as three bf16 terms of P), fp32 inputs to the
FMA kernel. The kernel has no backward: on CUDA tensors that need a
gradient (grad mode on and any input ``requires_grad``) the wrapper raises
instead of returning an output cut off from autograd; a caller that trains
takes a differentiable attention (``models.attention.gqa_forward`` does).
``flash_attention.launches`` counts kernel launches.

On DTensors (a mesh: ``launch.steps.build_case(mesh=...)``) each rank's
kernel takes its local ``[B/data, S, H/model, D]`` block through
``local_map`` and the output keeps q's placements; the counter counts each
rank's own launches. The kernel needs the whole sequence and head dim of
its heads: a q, k or v sharded along S (``hooks.shard_heads``' fallback
where heads do not divide the model axis) is gathered first, one sharded
along D raises ``ValueError``. k and v take q's batch and head shards
where their heads divide as q's do; otherwise each rank keeps them whole
and takes the kv heads its query heads read.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import localmap
from repro_torch.kernels import build

from .ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 160)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.fa_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.fa_forward.restype = ctypes.c_int
    lib.fa_error_string.argtypes = [ctypes.c_int]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q [B,S,Hq,D], k/v [B,S,Hkv,D] (``Hq % Hkv == 0``; query head h
    reads kv head ``h // (Hq/Hkv)``) -> [B,S,Hq,D] in q's dtype. Query
    and key positions are ``arange(S)``; ``window > 0`` keeps only keys
    with ``q_pos - k_pos < window``. Scores, softmax statistics and the
    accumulator are fp32."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q [B,S,Hq,D], k/v [B,S,Hkv,D]")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if tuple(k.shape) != (b, s, hkv, d) or tuple(v.shape) != tuple(k.shape) \
            or hkv == 0 or hq % hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if localmap.any_dtensor(q, k, v):
        return _on_mesh(q, k, v, causal, window, scale)
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            window=window, scale=scale)
        return out.transpose(1, 2)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: "
                         f"{sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward, so its output "
            "would carry no gradient to q, k and v; call it under "
            "torch.no_grad() or use a differentiable attention")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share fp32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, hkv, d, int(causal), window, _DTYPES[q.dtype],
            scale, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.fa_error_string(rc).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _on_mesh(q, k, v, causal, window, scale):
    """:func:`flash_attention` of DTensors, each rank's kernel on its local
    heads (module docstring)."""
    return localmap.heads_on_shards(
        lambda ql, kl, vl: flash_attention(
            ql.contiguous(), kl.contiguous(), vl.contiguous(),
            causal=causal, window=window, scale=scale),
        q, k, v, name="flash_attention")
