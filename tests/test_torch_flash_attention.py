"""Kernel K2 in the port: the flash-attention wrapper's plain version (what
it runs on CPU tensors) against the reference's oracle ``attention_ref``
and its Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances are the reference kernel tests': 2e-6 in fp32 and 2e-2 in bf16
(both sides read the same values and keep the softmax in fp32). The port
takes the model's layout ``[B, S, H, D]``; the oracles take
``[B, H, S, D]``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import requires_pallas
from repro.kernels.flash_attention import attention_ref as jax_ref
from repro.kernels.flash_attention import flash_attention_op
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.models import attention
from test_kernels import FA_SHAPES

torch.set_num_threads(1)
DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-6),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _case(b, hq, hkv, s, d, seed):
    """q [B,Hq,S,D], k/v [B,Hkv,S,D] fp32 numpy, the reference's layout."""
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(b, h, s, d))).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _port(q, k, v, tdt, **kw):
    """The wrapper on CPU tensors, in the model's layout, back to
    ``[B, H, S, D]`` fp32 numpy."""
    args = [torch.from_numpy(x).to(tdt).transpose(1, 2).contiguous()
            for x in (q, k, v)]
    out = flash_attention(*args, **kw)
    assert out.dtype == tdt and out.shape == args[0].shape
    return out.transpose(1, 2).float().numpy()


def _jax(q, k, v, jdt, **kw):
    out = jax_ref(*(jnp.asarray(x, jdt) for x in (q, k, v)), **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("b,hq,hkv,s,d", FA_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_the_reference_oracle(b, hq, hkv, s, d, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _case(b, hq, hkv, s, d, seed=s + hq)
    np.testing.assert_allclose(_port(q, k, v, tdt), _jax(q, k, v, jdt),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [32, 128])
def test_sliding_window(window):
    q, k, v = _case(1, 2, 2, 256, 64, seed=window)
    np.testing.assert_allclose(
        _port(q, k, v, torch.float32, window=window),
        _jax(q, k, v, jnp.float32, window=window), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("window", [0, 32])
def test_ragged_sequence(window):
    """S = 200 is not a multiple of any block; the Pallas kernel leaves rows
    >= 128 unwritten there, the oracle (and the port) do not."""
    q, k, v = _case(1, 4, 2, 200, 64, seed=7)
    got = _port(q, k, v, torch.float32, window=window)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(q, k, v, jnp.float32, window=window),
                               rtol=2e-6, atol=2e-6)


@requires_pallas
def test_plain_version_matches_the_pallas_kernel():
    q, k, v = _case(2, 8, 2, 256, 64, seed=1)
    want = flash_attention_op(*(jnp.asarray(x) for x in (q, k, v)),
                              interpret=True)
    np.testing.assert_allclose(_port(q, k, v, torch.float32),
                               np.asarray(want), rtol=2e-6, atol=2e-6)


def test_model_attention_matches_the_plain_version():
    """Prefill's attention (the wrapper, at positions ``arange(S)``) and
    decode's (``sdpa`` against explicit positions) compute one function."""
    q, k, v = _case(2, 8, 2, 96, 32, seed=5)
    qt, kt, vt = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    pos = torch.arange(96)[None].expand(2, 96)
    for window in (0, 16):
        got = flash_attention(qt, kt, vt, window=window)
        want = attention.sdpa(qt, kt, vt, pos, pos, window=window)
        torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


def test_wrapper_refuses_bad_shapes():
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=-1)


def _bf16_terms(p, n: int):
    """p as n bf16 terms, largest first: t_0 = bf16(p), t_1 = bf16(p -
    t_0), ...; each difference is exact in fp32."""
    terms = []
    for _ in range(n):
        terms.append(p.bfloat16().float())
        p = p - terms[-1]
    return terms


def _tiled_bf16_attention(q, k, v, p_terms, window: int = 0,
                          block_k: int = 64):
    """The bf16 kernel's arithmetic in plain PyTorch: fp32 scores of bf16
    q and k over kv tiles of ``block_k``, the online max and sum in fp32,
    and P V with P in fp32 (``p_terms`` 0, the FMA kernel) or as
    ``p_terms`` bf16 terms (1: P rounded once, as library flash attention
    does; 3: the tensor-core kernel). The output is rounded to bf16 once.
    Layout ``[B, H, S, D]``."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    k, v = (x.repeat_interleave(group, 1) for x in (k, v))
    pos = torch.arange(s)
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    for k0 in range(0, s, block_k):
        kp = pos[k0:k0 + block_k]
        seen = pos[:, None] >= kp[None, :]
        if window:
            seen &= (pos[:, None] - kp[None, :]) < window
        sc = q @ k[:, :, k0:k0 + block_k].transpose(-1, -2) / d ** 0.5
        sc = torch.where(seen, sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = v[:, :, k0:k0 + block_k]
        terms = _bf16_terms(p, p_terms) if p_terms else [p]
        acc = acc * alpha + sum(t @ vt for t in reversed(terms))
        m = m_new
    return (acc / l).bfloat16().float()


def _one_ulp_violations(shape, p_terms, window=0, seed=0):
    """Share of bf16 outputs further than one bf16 ulp of the answer
    (relative 2^-8, plus 1e-6) from the plain version run in fp32 on the
    same bf16 values: the card's check of the bf16 kernel."""
    q, k, v = (torch.from_numpy(x).bfloat16().float()
               for x in _case(*shape, seed=seed))
    got = _tiled_bf16_attention(q, k, v, p_terms, window=window)
    want = attention_ref(q, k, v, window=window)
    return float(((got - want).abs() > 1e-6 + 2.0 ** -8 * want.abs())
                 .float().mean())


# (B, Hq, Hkv, S, D, window): small causal shapes on the tests' inputs
SPLIT_CASES = [(1, 4, 2, 128, 64, 0), (1, 2, 1, 200, 32, 0),
               (1, 2, 2, 128, 128, 32)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_p_meets_one_ulp(case):
    """P V with P as two or three bf16 terms keeps every output within one
    bf16 ulp, as P in fp32 does."""
    *shape, window = case
    for p_terms in (0, 2, 3):
        assert _one_ulp_violations(shape, p_terms, window) == 0.0


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_rounding_p_alone_breaks_one_ulp(case):
    """P rounded once to bf16 before P V puts many outputs more than one
    bf16 ulp from the answer: the reason for the terms."""
    *shape, window = case
    assert _one_ulp_violations(shape, 1, window) > 0.05


def test_three_bf16_terms_carry_p_exactly():
    """Three bf16 terms add up to P exactly; two leave up to 2^-16 of it."""
    p = torch.from_numpy(np.random.default_rng(0).random(100_000)
                         .astype(np.float32))
    exact = p.double()
    three = sum(t.double() for t in _bf16_terms(p, 3))
    assert torch.equal(three, exact)
    rest = (exact - sum(t.double() for t in _bf16_terms(p, 2))).abs()
    assert 0 < float(rest.max()) and bool((rest <= 2.0 ** -16 * exact).all())
