"""K3's backward in the port: ``wkv_backward_scan``, the explicit reverse
recurrence in the order of the backward kernel (``csrc/wkv_backward.cu``:
the state kept at each chunk's start, a chunk's states recomputed from
it, then the walk back), held on the same numpy inputs against

- ``jax.vjp`` of the reference's ``repro.models.rwkv.wkv_scan`` (with its
  default chunk, and with ``chunk=8`` at S 32, its rematerialized path):
  within 1e-5 of each leaf's largest |gradient|, fp32 on both sides in
  other summation orders;
- autograd through the port's ``wkv_scan`` (what ``wkv_backward`` and
  ``WkvFunction`` run on CPU tensors): within 1e-6 of each leaf's
  largest |gradient| in fp32, 1e-12 in float64 (the same arithmetic up to
  the order of its sums).

Each case takes y's gradient alone (training) or with the final state's,
and chunks that leave a ragged last chunk or exceed S."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rwkv
from repro_torch.kernels.rwkv6 import (wkv_backward, wkv_backward_scan,
                                       wkv_train)

torch.set_num_threads(1)
SHAPES = [(1, 1, 1, 32), (2, 33, 2, 32), (2, 70, 3, 64)]
CHUNKS = [8, 16, 128]      # ragged tails at S 33 and 70; 128 exceeds S
JAX_TOL, F32_TOL, F64_TOL = 1e-5, 1e-6, 1e-12
NAMES = ("dr", "dk", "dv", "dw", "du")


@functools.cache
def _case(b, s, h, hd, with_state):
    rng = np.random.default_rng(1000 * s + 10 * hd + with_state)
    r, k, v = (0.3 * rng.normal(size=(3, b, s, h, hd))).astype(np.float32)
    w = np.exp(-np.exp(0.3 * rng.normal(size=(b, s, h, hd)))).astype(
        np.float32)
    u = (0.3 * rng.normal(size=(h, hd))).astype(np.float32)
    gy = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    gs = (rng.normal(size=(b, h, hd, hd)).astype(np.float32) if with_state
          else None)
    return (r, k, v, w, u), gy, gs


@functools.cache
def _reference(b, s, h, hd, with_state, chunk=ref_rwkv.WKV_CHUNK):
    """jax.vjp of the reference's wkv_scan on the case's inputs."""
    args, gy, gs = _case(b, s, h, hd, with_state)
    (y, sf), vjp = jax.vjp(
        lambda *a: ref_rwkv.wkv_scan(*a, chunk=chunk),
        *(jnp.asarray(x) for x in args))
    cot = (jnp.asarray(gy),
           jnp.zeros_like(sf) if gs is None else jnp.asarray(gs))
    return tuple(np.asarray(g) for g in vjp(cot))


def _explicit(args, gy, gs, chunk, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in args]
    return wkv_backward_scan(
        *t, torch.from_numpy(gy).to(dtype),
        None if gs is None else torch.from_numpy(gs).to(dtype), chunk=chunk)


def _close(got, want, tol):
    for name, g, x in zip(NAMES, got, want, strict=True):
        g, x = np.asarray(g), np.asarray(x)
        assert g.shape == x.shape, name
        scale = np.abs(x).max()
        np.testing.assert_allclose(g, x, rtol=0, atol=tol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("b,s,h,hd", SHAPES)
def test_explicit_backward_matches_the_reference_vjp(b, s, h, hd, chunk,
                                                    with_state):
    args, gy, gs = _case(b, s, h, hd, with_state)
    got = _explicit(args, gy, gs, chunk)
    _close([g.numpy() for g in got], _reference(b, s, h, hd, with_state),
           JAX_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_explicit_backward_matches_the_reference_remat_path(with_state):
    """S 32 in the reference's chunks of 8: its jax.checkpoint'ed scan over
    4 chunks, against the explicit recurrence in the kernel's chunks."""
    args, gy, gs = _case(2, 32, 2, 32, with_state)
    want = _reference(2, 32, 2, 32, with_state, chunk=8)
    for chunk in (8, 16):
        got = _explicit(args, gy, gs, chunk)
        _close([g.numpy() for g in got], want, JAX_TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.float64, F64_TOL)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("b,s,h,hd", SHAPES)
def test_explicit_backward_matches_autograd_through_the_port(
        b, s, h, hd, chunk, with_state, dtype, tol):
    args, gy, gs = _case(b, s, h, hd, with_state)
    got = _explicit(args, gy, gs, chunk, dtype)
    t = [torch.from_numpy(x).to(dtype) for x in args]
    want = wkv_backward(*t, torch.from_numpy(gy).to(dtype),
                        None if gs is None else torch.from_numpy(gs).to(dtype))
    for g in got:
        assert g.dtype == dtype
    _close([g.numpy() for g in got], [x.numpy() for x in want], tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_train_backward_on_the_cpu_is_wkv_backward(with_state):
    """``WkvFunction``'s backward on CPU tensors gives, bit for bit,
    ``wkv_backward``'s plain version (autograd through ``wkv_scan``)."""
    args, gy, gs = _case(2, 33, 2, 32, with_state)
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    y, s_final = wkv_train(*leaves)
    outs = [y] + ([s_final] if with_state else [])
    seeds = [torch.from_numpy(gy)] + ([torch.from_numpy(gs)] if with_state
                                      else [])
    got = torch.autograd.grad(outs, leaves, seeds)
    want = wkv_backward(*(torch.from_numpy(x) for x in args),
                        torch.from_numpy(gy),
                        torch.from_numpy(gs) if with_state else None)
    for name, a, b in zip(NAMES, got, want, strict=True):
        assert torch.equal(a, b), name


def test_wkv_backward_takes_a_state_gradient_alone():
    """The final state's gradient alone (y's None): the plain version and
    the explicit recurrence agree, and a missing pair raises."""
    args, _, gs = _case(2, 33, 2, 32, True)
    t = [torch.from_numpy(x) for x in args]
    got = wkv_backward_scan(*t, None, torch.from_numpy(gs), chunk=8)
    want = wkv_backward(*t, None, torch.from_numpy(gs))
    _close([g.numpy() for g in got], [x.numpy() for x in want], F32_TOL)
    with pytest.raises(ValueError, match="no output gradient"):
        wkv_backward(*t, None, None)
    with pytest.raises(ValueError, match="grad_y"):
        wkv_backward(*t, torch.zeros(1), None)
