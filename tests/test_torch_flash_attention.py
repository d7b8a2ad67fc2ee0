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
