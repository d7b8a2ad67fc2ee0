"""Kernel K3 in the port: the wkv wrapper's plain version (what it runs on
CPU tensors) against the reference's oracle ``wkv_ref`` and its Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerance 1e-5 absolute and relative on y and on the final state, the
reference kernel tests' (fp32 on both sides, other summation order).

``wkv_train`` (the recurrence for training) on the CPU: its outputs and
gradients equal, bit for bit, autograd straight through ``wkv_scan`` on
the same inputs and output gradients (the same plain arithmetic), and it
passes ``torch.autograd.gradcheck`` in float64."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import requires_pallas
from repro.kernels.rwkv6 import wkv_op, wkv_ref
import repro_torch.configs  # noqa: F401  (registry)
from repro_torch.kernels.rwkv6 import wkv, wkv_scan, wkv_train
from repro_torch.models import rwkv
from repro_torch.models.base import get_config
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


def _leaves(args, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype).requires_grad_() for x in args]


@pytest.mark.parametrize("b,t,h,hd", [(2, 1, 2, 64), (2, 31, 2, 64),
                                      (1, 64, 3, 32), (3, 37, 1, 64)],
                         ids=["S1", "S31", "S64", "ragged"])
@pytest.mark.parametrize("outputs", ["y", "y+state"])
def test_wkv_train_gradients_equal_autograd_through_the_scan(b, t, h, hd,
                                                             outputs):
    """At S 1, w reaches only the state: y's gradient leaves it zero."""
    args = _case(b, t, h, hd, seed=t + 7)
    got_in, want_in = _leaves(args), _leaves(args)
    got, want = wkv_train(*got_in), wkv_scan(*want_in)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    rng = np.random.default_rng(t)
    used = slice(None) if outputs == "y+state" else slice(0, 1)
    seeds = [torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
             for x in want[used]]
    got_g = torch.autograd.grad(got[used], got_in, seeds)
    want_g = torch.autograd.grad(want[used], want_in, seeds,
                                 materialize_grads=True)
    for name, g, w in zip("rkvwu", got_g, want_g, strict=True):
        assert torch.equal(g, w), name


def test_wkv_train_passes_gradcheck():
    args = _case(1, 5, 2, 4, seed=3)
    assert torch.autograd.gradcheck(wkv_train, _leaves(args, torch.float64))


def test_wkv_train_differentiates_only_what_needs_it():
    r, k, v, w, u = _leaves(_case(1, 9, 2, 32, seed=4))
    y, _ = wkv_train(r.detach(), k, v.detach(), w.detach(), u.detach())
    (gk,) = torch.autograd.grad(y.sum(), [k])
    want = torch.autograd.grad(wkv_scan(r, k, v, w, u)[0].sum(), [k])[0]
    assert torch.equal(gk, want)


def test_time_mix_trains_through_wkv_train(monkeypatch):
    """Under grad ``time_mix`` goes through ``wkv_train`` (no carried
    state); with a carried state, through the plain ``wkv_scan``."""
    cfg = get_config("rwkv6-1.6b", smoke=True)
    g = torch.Generator().manual_seed(0)
    p = rwkv.init_time_mix(g, cfg)
    x = torch.randn((2, 12, cfg.d_model), generator=g).requires_grad_()
    calls = []
    monkeypatch.setattr(rwkv, "wkv_train",
                        lambda *a: calls.append(1) or wkv_train(*a))
    out, _, _ = rwkv.time_mix(cfg, p, x)
    out.square().sum().backward()
    assert calls == [1]
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    state = torch.zeros((2, rwkv.n_heads(cfg), 64, 64))
    rwkv.time_mix(cfg, p, x[:, :1], state=state, last_x=x[:, 0])
    assert calls == [1]
