"""The port's multi-head latent attention (``models/attention.py``'s MLA
part) against the JAX reference's on the CPU, on the minicpm3-4b smoke
config (fp32), with the reference's parameters carried across by
``interop.lm_params_from_jax``: ``_mla_ckv`` (what the decode cache
holds), ``mla_forward`` through the kernel's wrapper and through the
differentiable ``sdpa``, and the absorbed ``mla_decode`` step by step
over a full and a ring-buffer cache. Also the kernel's call with MLA's
head dims (q.k and v zero-padded to one head dim the kernel takes, the
plain version on the CPU) against the plain ``sdpa`` on the unpadded
tensors, and stablelm-12b's head dim 160 through the wrapper against the
reference's oracle.

Tolerances: layer outputs and caches 1e-4 (``test_torch_lm.py``'s
``TOL``); attention against attention on the same tensors 2e-6 (the
reference kernel tests' fp32 tolerance).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
import repro_torch.configs  # noqa: F401  (registry)
from repro.kernels.flash_attention import attention_ref as jax_ref
from repro.models import attention as ref_attn
from repro.models.base import get_config as ref_get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention
from repro_torch.models.base import get_config

torch.set_num_threads(1)
ARCH = "minicpm3-4b"
TOL, ATTN_TOL = 1e-4, 2e-6


def _setup(seed=0, b=2, s=24):
    rcfg, cfg = ref_get_config(ARCH, smoke=True), get_config(ARCH,
                                                            smoke=True)
    ref_p = ref_attn.init_mla(jax.random.PRNGKey(seed), rcfg)
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(
        np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    return rcfg, cfg, ref_p, lm_params_from_jax(ref_p), x, pos


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def test_compressed_kv_matches_the_reference():
    rcfg, cfg, ref_p, p, x, pos = _setup()
    want = ref_attn._mla_ckv(rcfg, ref_p, jnp.asarray(x), jnp.asarray(pos))
    got = attention._mla_ckv(cfg, p, torch.from_numpy(x),
                             torch.from_numpy(pos))
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)


@pytest.mark.parametrize("window", [0, 8])
def test_mla_forward_matches_the_reference(window):
    """Without a gradient through the kernel's wrapper (its plain version
    here, on the padded tensors), with one through ``sdpa``: both equal the
    reference's ``mla_forward``, and each other."""
    rcfg, cfg, ref_p, p, x, pos = _setup(seed=1)
    want = ref_attn.mla_forward(rcfg, ref_p, jnp.asarray(x),
                                jnp.asarray(pos), window=window)
    xt, post = torch.from_numpy(x), torch.from_numpy(pos)
    with torch.no_grad():
        got = attention.mla_forward(cfg, p, xt, post, window=window)
    _close(got.numpy(), want)
    xg = xt.clone().requires_grad_()
    trained = attention.mla_forward(cfg, p, xg, post, window=window)
    trained.square().sum().backward()
    _close(trained.detach().numpy(), want)
    torch.testing.assert_close(trained.detach(), got, rtol=2e-5,
                               atol=2e-5)
    assert bool(torch.isfinite(xg.grad).all())


@pytest.mark.parametrize("window", [0, 8])
def test_absorbed_decode_matches_the_reference(window):
    """Twelve one-token steps from an empty cache of 12 slots (full) or of
    the window's 8 (a ring buffer from the ninth step on): outputs and
    caches against the reference's step by step."""
    rcfg, cfg, ref_p, p, x, _ = _setup(seed=2, b=2, s=12)
    cache_len = 12 if window == 0 else window
    ref_cache = ref_attn.mla_init_cache(rcfg, 2, cache_len)
    cache = attention.mla_init_cache(cfg, 2, cache_len, "cpu")
    for t in range(12):
        pos = np.full((2,), t, np.int32)
        want, ref_cache = ref_attn.mla_decode(
            rcfg, ref_p, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos),
            ref_cache, window=window)
        got, cache = attention.mla_decode(
            cfg, p, torch.from_numpy(x[:, t:t + 1]), torch.from_numpy(pos),
            cache, window=window)
        _close(got.numpy(), want, msg=f"step {t}")
    for name in ("c_kv", "k_rope"):
        _close(cache[name].numpy(), ref_cache[name])
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(ref_cache["slot_pos"]))


@pytest.mark.parametrize("dims", [(48, 32, 64), (96, 64, 128)],
                         ids=["smoke", "full"])
def test_padded_kernel_call_matches_sdpa_on_the_unpadded_tensors(dims):
    """MLA's head dims reach the kernel's wrapper zero-padded to the
    smallest head dim it takes (64 for the smoke config's 48 and 32, 128
    for minicpm3-4b's 96 and 64) with the scale of the unpadded q.k; the
    output, sliced back, is the plain ``sdpa``'s on the unpadded tensors."""
    dq, dv, d = dims
    g = torch.Generator().manual_seed(dq)
    b, s, h = 2, 70, 3
    q, k = (0.3 * torch.randn((b, s, h, dq), generator=g) for _ in "qk")
    v = 0.3 * torch.randn((b, s, h, dv), generator=g)
    pos = torch.arange(s)[None].expand(b, s)
    seen = []
    real = attention.flash_attention

    def spy(*args, **kw):
        seen.append((args[0].shape[-1], kw["scale"]))
        return real(*args, **kw)

    attention.flash_attention = spy
    try:
        for window in (0, 16):
            got = attention.mla_attention(q, k, v, window=window)
            want = attention.sdpa(q, k, v, pos, pos, window=window)
            assert got.shape == (b, s, h, dv)
            torch.testing.assert_close(got, want, rtol=ATTN_TOL,
                                       atol=ATTN_TOL)
    finally:
        attention.flash_attention = real
    assert seen == [(d, 1.0 / dq ** 0.5)] * 2


@pytest.mark.parametrize("window", [0, 32])
def test_head_dim_160_through_the_wrapper(window):
    """stablelm-12b's head dim (5120 / 32 = 160) through the wrapper's
    plain version against the reference's oracle, in the model's layout."""
    assert get_config("stablelm-12b").hd == 160
    rng = np.random.default_rng(window)
    q, k, v = ((0.3 * rng.normal(size=(1, h, 96, 160))).astype(np.float32)
               for h in (4, 2, 2))
    want = jax_ref(*(jnp.asarray(a) for a in (q, k, v)), window=window)
    got = flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                            for a in (q, k, v)), window=window)
    assert got.shape == (1, 96, 4, 160)
    _close(got.transpose(1, 2).numpy(), want, ATTN_TOL)
