"""Wrappers of the RWKV6 wkv CUDA kernels (``csrc/wkv.cu`` and
``csrc/wkv_backward.cu``).

``wkv`` runs the wkv recurrence over a whole sequence from a zero state —
the function of the TPU kernel ``repro/kernels/rwkv6`` — and returns the
outputs and the final state (the decode cache's ``s``). On CUDA tensors it
launches the kernel (built at first use) and raises on what the kernel
does not take; on CPU tensors it runs the plain version ``wkv_scan``.
The forward kernel has no autograd of its own: on CUDA tensors that need
a gradient (grad mode on and any input ``requires_grad``) the wrapper
raises instead of returning outputs cut off from autograd.
``wkv.launches`` counts kernel launches.

``wkv_backward`` gives the gradients of ``(y, S_final) = wkv(r, k, v, w,
u)`` for given output gradients. On CUDA tensors it launches the backward
kernel (one launch a call; ``wkv_backward.launches`` counts them), which
keeps the state at each chunk's start and recomputes a chunk's states
before walking it back; on CPU tensors it runs the plain version,
autograd through ``wkv_scan``.

``wkv_train`` is the recurrence for training: an autograd function whose
forward is ``wkv`` (the kernel on CUDA tensors) and whose backward is
``wkv_backward`` (the backward kernel on CUDA tensors, autograd through
the plain ``wkv_scan`` on CPU tensors).

On DTensors (a mesh) both run on each rank's local ``[B/data, S,
H/model, hd]`` block through ``local_map`` (:func:`on_mesh`): the
recurrence is independent per (batch row, head), so the outputs keep r's
batch and head shards; an input sharded along S is gathered first (the
scan needs the whole sequence), one sharded along hd raises
``ValueError``. ``local_map`` hands the backward each rank's local
tensors, so the backward kernel runs on the rank's own shards too. The
counters count each rank's own launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import localmap
from repro_torch.kernels import build

from .ref import wkv_scan

HEAD_DIMS = (32, 64)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("wkv")
    lib.wkv_forward.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.wkv_forward.restype = ctypes.c_int
    lib.wkv_error_string.argtypes = [ctypes.c_int]
    lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def wkv(r, k, v, w, u):
    """r, k, v, w [B,S,H,hd] fp32; u [H,hd] fp32 -> (y [B,S,H,hd] fp32,
    S_final [B,H,hd,hd] fp32), from a zero state."""
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError("expected r, k, v, w [B,S,H,hd] and u [H,hd]")
    b, s, h, hd = r.shape
    if any(tuple(x.shape) != (b, s, h, hd) for x in (k, v, w)) or \
            tuple(u.shape) != (h, hd):
        raise ValueError(
            f"shape mismatch: r/k/v/w {[tuple(x.shape) for x in (r, k, v, w)]}"
            f", u {tuple(u.shape)}")
    if localmap.any_dtensor(r, k, v, w, u):
        return on_mesh(wkv, r, k, v, w, u)
    tensors = (r, k, v, w, u)
    devices = {x.device for x in tensors}
    if devices == {torch.device("cpu")}:
        return wkv_scan(r, k, v, w, u)
    if len(devices) != 1 or r.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: "
                         f"{sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(
            "wkv: the CUDA kernel has no backward, so its outputs would "
            "carry no gradient to r, k, v, w and u; call it under "
            "torch.no_grad()")
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"r, k, v, w and u must be fp32, got "
                        f"{[str(x.dtype) for x in tensors]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("r, k, v, w and u must be contiguous")
    if any(x.data_ptr() % 16 for x in (r, k, v, w)):
        raise ValueError("r, k, v and w must be 16-byte aligned")
    y = torch.empty_like(r)
    s_final = torch.empty((b, h, hd, hd), dtype=torch.float32,
                          device=r.device)
    if b * h == 0:
        return y, s_final
    lib = _library()
    with torch.cuda.device(r.device):
        rc = lib.wkv_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s_final.data_ptr(), b, s, h, hd,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("wkv kernel launch failed: "
                           + lib.wkv_error_string(rc).decode())
    wkv.launches += 1
    return y, s_final


wkv.launches = 0


@functools.cache
def _backward_library() -> ctypes.CDLL:
    lib = build.load("wkv_backward")
    lib.wkv_backward.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.wkv_backward.restype = ctypes.c_int
    lib.wkv_backward_chunk.argtypes = [ctypes.c_int]
    lib.wkv_backward_chunk.restype = ctypes.c_int
    lib.wkv_backward_error_string.argtypes = [ctypes.c_int]
    lib.wkv_backward_error_string.restype = ctypes.c_char_p
    return lib


def _plain_backward(inputs, needs, grad_y, grad_s):
    """Autograd through the plain ``wkv_scan`` recomputed on ``inputs``
    (r, k, v, w, u): the gradients of the inputs flagged in ``needs``
    (None for the others) for output gradients ``grad_y`` and ``grad_s``
    (either may be None, not both)."""
    pairs = [(o, g) for o, g in zip((0, 1), (grad_y, grad_s))
             if g is not None]
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(inputs, needs)]
        outs = wkv_scan(*inputs)
        wanted = [x for x in inputs if x.requires_grad]
        # materialize_grads: an input the used outputs do not reach (w for
        # y at S = 1) gets a zero gradient
        grads = iter(torch.autograd.grad(
            [outs[o] for o, _ in pairs], wanted, [g for _, g in pairs],
            materialize_grads=True))
    return tuple(next(grads) if x.requires_grad else None for x in inputs)


def _aligned(x):
    """``x`` contiguous and 16-byte aligned (an output gradient from
    autograd may be a view or an expanded tensor), copied only if not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def wkv_backward(r, k, v, w, u, grad_y, grad_s=None):
    """Gradients of ``(y, S_final) = wkv(r, k, v, w, u)``: r, k, v, w
    [B,S,H,hd] fp32, u [H,hd]; ``grad_y`` [B,S,H,hd] and ``grad_s``
    [B,H,hd,hd] the outputs' gradients (either may be None, a zero
    gradient). Returns (dr, dk, dv, dw, du)."""
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError("expected r, k, v, w [B,S,H,hd] and u [H,hd]")
    b, s, h, hd = r.shape
    if any(tuple(x.shape) != (b, s, h, hd) for x in (k, v, w)) or \
            tuple(u.shape) != (h, hd):
        raise ValueError(
            f"shape mismatch: r/k/v/w {[tuple(x.shape) for x in (r, k, v, w)]}"
            f", u {tuple(u.shape)}")
    if grad_y is None and grad_s is None:
        raise ValueError("wkv_backward: no output gradient given")
    if grad_y is not None and tuple(grad_y.shape) != (b, s, h, hd):
        raise ValueError(f"grad_y {tuple(grad_y.shape)}, want "
                         f"{(b, s, h, hd)}")
    if grad_s is not None and tuple(grad_s.shape) != (b, h, hd, hd):
        raise ValueError(f"grad_s {tuple(grad_s.shape)}, want "
                         f"{(b, h, hd, hd)}")
    grads = [g for g in (grad_y, grad_s) if g is not None]
    tensors = (r, k, v, w, u)
    devices = {x.device for x in tensors + tuple(grads)}
    if devices == {torch.device("cpu")}:
        return _plain_backward(tensors, (True,) * 5, grad_y, grad_s)
    if len(devices) != 1 or r.device.type != "cuda":
        raise ValueError(f"tensors on mixed or unsupported devices: "
                         f"{sorted(map(str, devices))}")
    if any(x.dtype != torch.float32 for x in tensors + tuple(grads)):
        raise TypeError(f"r, k, v, w, u and the output gradients must be "
                        f"fp32, got {[str(x.dtype) for x in tensors]} and "
                        f"{[str(g.dtype) for g in grads]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("r, k, v, w and u must be contiguous")
    if any(x.data_ptr() % 16 for x in (r, k, v, w)):
        raise ValueError("r, k, v and w must be 16-byte aligned")
    dy = torch.zeros_like(r) if grad_y is None else _aligned(grad_y)
    ds = None if grad_s is None else _aligned(grad_s)
    if b * h * s == 0:
        return (*(torch.zeros_like(r) for _ in range(4)), torch.zeros_like(u))
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)
    lib = _backward_library()
    n_chunks = -(-s // lib.wkv_backward_chunk(hd))
    ws = torch.empty((b, h, n_chunks, hd, hd), dtype=torch.float32,
                     device=r.device)
    with torch.cuda.device(r.device):
        rc = lib.wkv_backward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr(),
            None if ds is None else ds.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
            ws.data_ptr(), b, s, h, hd,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("wkv backward kernel launch failed: "
                           + lib.wkv_backward_error_string(rc).decode())
    wkv_backward.launches += 1
    # du: the blocks' partial sums over b in a fixed order (no atomics)
    return dr, dk, dv, dw, du_part.sum(0)


wkv_backward.launches = 0


class WkvFunction(torch.autograd.Function):
    """The wkv recurrence under autograd.

    *Forward:* :func:`wkv` without grad (one kernel launch on CUDA
    tensors, the plain ``wkv_scan`` on CPU tensors); it keeps r, k, v, w
    and u, 4 x ``[B,S,H,hd]`` fp32 and ``[H,hd]``, for the backward pass,
    instead of the per-step states autograd would keep through the plain
    loop (three ``[B,H,hd,hd]`` tensors a step).

    *Backward:* :func:`wkv_backward` on the kept inputs. On CUDA tensors
    that is one launch of the backward kernel (it never runs the plain
    loop there); on CPU tensors autograd through the plain ``wkv_scan``
    recomputed on them, so the gradients are exactly those of the plain
    recurrence at the same inputs. Only ``y``'s gradient is used when the
    final state's is ``None`` (training).
    """

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        with torch.no_grad():
            y, s_final = wkv(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        return y, s_final

    @staticmethod
    def backward(ctx, grad_y, grad_s):
        needs = ctx.needs_input_grad
        if (grad_y is None and grad_s is None) or not any(needs):
            return (None,) * 5
        saved = ctx.saved_tensors
        if saved[0].device.type == "cpu":
            return _plain_backward(saved, needs, grad_y, grad_s)
        grads = wkv_backward(*saved, grad_y, grad_s)
        return tuple(g if need else None for g, need in zip(grads, needs))


def wkv_train(r, k, v, w, u):
    """:func:`wkv` for training: the same outputs, differentiable in r, k,
    v, w and u (:class:`WkvFunction`). On CUDA tensors the forward and the
    backward each launch their kernel or raise; neither runs the plain
    loop there."""
    if localmap.any_dtensor(r, k, v, w, u):
        return on_mesh(wkv_train, r, k, v, w, u)
    return WkvFunction.apply(r, k, v, w, u)


def on_mesh(fn, r, k, v, w, u, *rest):
    """``fn(r, k, v, w, u, *rest)`` (a wkv of ``[B,S,H,hd]`` inputs, ``u``
    ``[H,hd]`` and ``rest`` carried states ``[B,H,hd,hd]``, returning
    ``(y, S_final)``) on each rank's local batch rows and heads."""
    from torch.distributed.tensor import Shard

    lm = localmap
    ref = next(x for x in (r, k, v, w) if lm.is_dtensor(x))
    ref = lm.settle(ref, (0, 2), "wkv r", strict=(3,))
    seq = [lm.like(lm.settle(x, (0, 2), "wkv input", strict=(3,))
                   if lm.is_dtensor(x) else x, ref, {0: 0, 2: 2})
           for x in (r, k, v, w)]
    u = lm.like(u, ref, {2: 0})
    rest = [lm.like(x, ref, {0: 0, 2: 1}) for x in rest]
    y_pl = tuple(seq[0].placements)
    s_pl = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
                 for p in y_pl)
    return lm.on_shards(fn, (*seq, u, *rest), (y_pl, s_pl))
