"""Kernel K3 in the port: the wkv wrapper's plain version (what it runs on
CPU tensors) against the reference's oracle ``wkv_ref`` and its Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerance 1e-5 absolute and relative on y and on the final state, the
reference kernel tests' (fp32 on both sides, other summation order)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import requires_pallas
from repro.kernels.rwkv6 import wkv_op, wkv_ref
from repro_torch.kernels.rwkv6 import wkv, wkv_scan
from test_kernels import RW_SHAPES

torch.set_num_threads(1)
TOL = 1e-5


def _case(b, t, h, hd, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (0.3 * rng.normal(size=(3, b, t, h, hd))).astype(np.float32)
    w = np.exp(-np.exp(0.3 * rng.normal(size=(b, t, h, hd)))).astype(
        np.float32)
    u = (0.3 * rng.normal(size=(h, hd))).astype(np.float32)
    return r, k, v, w, u


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def _port(args):
    y, s = wkv(*(torch.from_numpy(x) for x in args))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("b,t,h,hd", RW_SHAPES)
def test_plain_version_matches_the_reference_oracle(b, t, h, hd):
    args = _case(b, t, h, hd, seed=t)
    y, s = _port(args)
    y_ref, s_ref = wkv_ref(*(jnp.asarray(x) for x in args))
    assert s.shape == (b, h, hd, hd)
    _close(y, y_ref)
    _close(s, s_ref)


@requires_pallas
@pytest.mark.parametrize("b,t,h,hd", RW_SHAPES)
def test_plain_version_matches_the_pallas_kernel(b, t, h, hd):
    args = _case(b, t, h, hd, seed=t + 1)
    y, s = _port(args)
    y_k, s_k = wkv_op(*(jnp.asarray(x) for x in args), interpret=True)
    _close(y, y_k)
    _close(s, s_k)


def test_ragged_sequence():
    """S = 100 is not a multiple of the Pallas kernel's block_t (64), which
    it refuses; the oracle and the port take any S."""
    args = _case(2, 100, 2, 64, seed=100)
    y, s = _port(args)
    y_ref, s_ref = wkv_ref(*(jnp.asarray(x) for x in args))
    _close(y, y_ref)
    _close(s, s_ref)


def test_carried_state_continues_the_sequence():
    """Two halves with the state carried equal one pass (decode relies on
    it)."""
    r, k, v, w, u = (torch.from_numpy(x) for x in _case(1, 40, 2, 32, 9))
    y, s = wkv_scan(r, k, v, w, u)
    y1, s1 = wkv_scan(r[:, :25], k[:, :25], v[:, :25], w[:, :25], u)
    y2, s2 = wkv_scan(r[:, 25:], k[:, 25:], v[:, 25:], w[:, 25:], u, s0=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s2, s, rtol=TOL, atol=TOL)


def test_wrapper_refuses_bad_shapes():
    r = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="shape"):
        wkv(r, r, r, r, torch.zeros(3, 32))


def _grouped_scan(r, k, v, w, u, groups: int):
    """The CUDA kernel's arithmetic in plain PyTorch: ``groups`` row groups
    of the state, each adding its rows' part of y_j, sum_{i in g} r_i S_ij
    + b_g v_j, with the group's bonus b_g = sum_{i in g} r_i u_i k_i folded
    in; the parts of a column are summed in group order. Then each group
    updates its rows, S_ij <- w_i S_ij + k_i v_j."""
    b, s, h, hd = r.shape
    rows = hd // groups
    state = torch.zeros((b, h, groups, rows, hd))
    ug = u.reshape(h, groups, rows)
    ys = []
    for t in range(s):
        rt, kt, wt = (x[:, t].reshape(b, h, groups, rows) for x in (r, k, w))
        vt = v[:, t, :, None, :]                          # [B,H,1,hd]
        bonus = (rt * ug * kt).sum(-1, keepdim=True)      # [B,H,G,1]
        part = bonus * vt + (rt[..., None] * state).sum(3)
        y = part[:, :, 0]
        for g in range(1, groups):
            y = y + part[:, :, g]
        ys.append(y)
        state = wt[..., None] * state + kt[..., None] * vt[:, :, :, None]
    return torch.stack(ys, 1), state.reshape(b, h, hd, hd)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("groups", [1, 4, 8])
def test_row_grouped_step_matches_the_scan(groups, hd):
    args = _case(2, 40, 2, hd, seed=groups + hd)
    y, s = _grouped_scan(*(torch.from_numpy(x) for x in args), groups)
    y_ref, s_ref = _port(args)
    _close(y.numpy(), y_ref)
    _close(s.numpy(), s_ref)
    y_jax, s_jax = wkv_ref(*(jnp.asarray(x) for x in args))
    _close(y.numpy(), y_jax)
    _close(s.numpy(), s_jax)
