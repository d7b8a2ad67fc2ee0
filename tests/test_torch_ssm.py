"""The hybrid family (hymba) against the JAX reference on the CPU: the mamba
branch's pieces (``_conv_causal`` in both modes, ``ssm_scan`` in one chunk
and in the reference's chunks, ``ssm_forward``, ``ssm_decode``) on the
same numpy inputs and the reference's parameters (fp32, within 1e-5), its
init's tree, dtypes and scales, the hymba-smoke ``prefill`` and
``decode_step`` against the reference's (ring buffer included, 1e-4 as
``test_torch_lm.py``), and the port's own prefill-then-decode against its
forward (1e-4), past the sliding window."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
import repro_torch.configs  # noqa: F401  (registry)
from repro.models import api as ref_api
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models.base import get_config as ref_get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import api, ssm, transformer
from repro_torch.models.base import get_config

torch.set_num_threads(1)
ARCH = "hymba-1.5b"
TOL = 1e-5      # one module, fp32, other summation order
LM_TOL = 1e-4   # a whole model, as test_torch_lm.py


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _ssm_params(seed=0, **overrides):
    rcfg = ref_get_config(ARCH, smoke=True).replace(**overrides)
    cfg = get_config(ARCH, smoke=True).replace(**overrides)
    rp = ref_ssm.init_ssm(jax.random.PRNGKey(seed), rcfg)
    # a_log and dt_bias off their init constants, so every decay differs
    rng = np.random.default_rng(seed)
    rp = dict(rp, a_log=rp["a_log"] + 0.3 * rng.normal(
        size=rp["a_log"].shape).astype(np.float32),
        dt_bias=rp["dt_bias"] + 0.5 * rng.normal(
            size=rp["dt_bias"].shape).astype(np.float32))
    return rcfg, rp, cfg, lm_params_from_jax(rp)


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def test_conv_causal_matches_the_reference_in_both_modes():
    rcfg, rp, cfg, p = _ssm_params()
    di = ssm.d_inner(cfg)
    u = _x((2, 11, di))
    want, _ = ref_ssm._conv_causal(rp, jnp.asarray(u))
    got, none = ssm._conv_causal(p, torch.from_numpy(u))
    assert none is None and got.shape == want.shape
    _close(got, want)
    conv = _x((2, cfg.ssm_conv - 1, di), seed=2)
    want, want_win = ref_ssm._conv_causal(rp, jnp.asarray(u[:, :1]),
                                          conv_cache=jnp.asarray(conv))
    got, win = ssm._conv_causal(p, torch.from_numpy(u[:, :1]),
                                conv_cache=torch.from_numpy(conv))
    _close(got, want)
    np.testing.assert_array_equal(win.numpy(), np.asarray(want_win))


@pytest.mark.parametrize("s,chunk", [(12, 8), (32, 8), (7, 512)],
                         ids=["ragged-one-chunk", "chunked", "short"])
def test_ssm_scan_matches_the_reference(s, chunk):
    """S above the reference's chunk (and a multiple of it) runs its
    chunked scan; otherwise one chunk. One loop gives both. Also from a
    carried state h0."""
    rcfg, rp, cfg, p = _ssm_params()
    di = ssm.d_inner(cfg)
    u = _x((2, s, di), scale=0.5)
    h0 = _x((2, di, cfg.ssm_state), seed=3, scale=0.2)
    for init in (None, h0):
        want_y, want_h = ref_ssm.ssm_scan(
            rcfg, rp, jnp.asarray(u), chunk=chunk,
            h0=None if init is None else jnp.asarray(init))
        got_y, got_h = ssm.ssm_scan(
            cfg, p, torch.from_numpy(u),
            h0=None if init is None else torch.from_numpy(init))
        assert got_y.dtype == torch.float32 and got_h.shape == want_h.shape
        _close(got_y, want_y)
        _close(got_h, want_h)


def test_ssm_forward_and_decode_match_the_reference():
    rcfg, rp, cfg, p = _ssm_params()
    x = _x((2, 9, cfg.d_model), scale=0.5)
    _close(ssm.ssm_forward(cfg, p, torch.from_numpy(x)),
           ref_ssm.ssm_forward(rcfg, rp, jnp.asarray(x)))
    rcache = ref_ssm.ssm_init_cache(rcfg, 2)
    cache = ssm.ssm_init_cache(cfg, 2, "cpu")
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(rcache)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for t in range(5):
        want, rcache = ref_ssm.ssm_decode(rcfg, rp, jnp.asarray(x[:, t:t + 1]),
                                          rcache)
        got, cache = ssm.ssm_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]),
                                    cache)
        _close(got, want, msg=f"step {t}")
        _close(cache["h"], rcache["h"])
        _close(cache["conv"], rcache["conv"])


def test_ssm_branch_returns_the_scans_final_state():
    """Prefill takes the final state and the pre-conv ``u`` from the same
    pass as the output: the state equals a second scan's, as the
    reference computes it, and the conv tail is ``u``'s last positions
    (zero-padded in front when S is shorter)."""
    rcfg, rp, cfg, p = _ssm_params()
    for s in (2, 9):
        x = _x((2, s, cfg.d_model), scale=0.5)
        out, h, u = ssm.ssm_branch(cfg, p, torch.from_numpy(x))
        uu, _ = jnp.split(jnp.asarray(x) @ rp["w_in"], 2, axis=-1)
        uc, _ = ref_ssm._conv_causal(rp, uu)
        uc = jax.nn.silu(uc)
        _, want_h = ref_ssm.ssm_scan(rcfg, rp, uc)
        _close(h, want_h)
        tail = ssm.conv_tail(cfg, u)
        want_tail = jnp.concatenate(
            [jnp.zeros((2, cfg.ssm_conv - 1, uu.shape[-1])), uu],
            axis=1)[:, -(cfg.ssm_conv - 1):]
        _close(tail, want_tail)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_follows_the_reference(dtype):
    """The same tree, shapes and dtypes as the reference's hymba init
    (``dt_bias``, ``a_log`` and ``d_skip`` fp32 in a bf16 model), the same
    constants, and the same scales."""
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    ref = ref_api.init_params(
        ref_get_config(ARCH, smoke=True).replace(dtype=dtype),
        jax.random.PRNGKey(0))
    assert jax.tree.structure(ref) == jax.tree.structure(params)
    for x, y in zip(jax.tree.leaves(params), jax.tree.leaves(ref)):
        assert tuple(x.shape) == y.shape
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
        sx, sy = float(x.float().std()), float(np.asarray(y, np.float32).std())
        if sy == 0.0:
            np.testing.assert_array_equal(x.float().numpy(),
                                          np.asarray(y, np.float32))
        else:
            assert abs(sx / sy - 1) < 0.25
    for name in ("dt_bias", "a_log", "d_skip"):
        assert params["layers"]["ssm"][name].dtype == torch.float32
    np.testing.assert_allclose(params["layers"]["ssm"]["a_log"].numpy(),
                               np.asarray(ref["layers"]["ssm"]["a_log"]),
                               rtol=1e-7, atol=0)


def _models(seed=3):
    rcfg = ref_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    ref_params = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, ref_params, cfg, lm_params_from_jax(ref_params)


@pytest.mark.parametrize("s_pre", [24, 70], ids=["in-window", "ring"])
def test_prefill_and_decode_match_the_reference(s_pre):
    """hymba-smoke (window 64): a prefill inside the window (cache padded
    by ``cache_extra``) and one past it (a 64-slot ring buffer, left as
    it is), then 8 decode steps; logits and the final cache."""
    rcfg, rp, cfg, p = _models()
    b, s_gen = 2, 8
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s_pre + s_gen)).astype(np.int32)
    want, rcache = ref_tf.prefill(rcfg, rp, jnp.asarray(toks[:, :s_pre]),
                                  cache_extra=s_gen)
    got, cache = transformer.prefill(cfg, p, torch.from_numpy(toks[:, :s_pre]),
                                     cache_extra=s_gen)
    _close(got, want, LM_TOL, "prefill logits")
    assert [tuple(x.shape) for x in jax.tree.leaves(cache)] == \
        [tuple(x.shape) for x in jax.tree.leaves(rcache)]
    assert cache["attn"]["slot_pos"].shape[-1] == min(s_pre + s_gen, 64)
    for t in range(s_pre, s_pre + s_gen):
        pos = np.full((b,), t, np.int32)
        want, rcache = ref_tf.decode_step(rcfg, rp, rcache,
                                          jnp.asarray(toks[:, t:t + 1]),
                                          jnp.asarray(pos))
        got, cache = transformer.decode_step(
            cfg, p, cache, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos))
        _close(got, want, LM_TOL, f"decode at position {t}")
    for x, y in zip(jax.tree.leaves(cache), jax.tree.leaves(rcache)):
        if x.dtype == torch.int32:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            _close(x, y, LM_TOL, "final cache")
    empty = transformer.init_cache(cfg, b, 40, device="cpu")
    for x, y in zip(jax.tree.leaves(empty),
                    jax.tree.leaves(ref_tf.init_cache(rcfg, b, 40))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_forward_and_loss_match_the_reference():
    rcfg, rp, cfg, p = _models()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    mask = (rng.random((2, 32)) > 0.2).astype(np.float32)
    want, _ = ref_tf.forward(rcfg, rp, jnp.asarray(toks))
    got, aux = transformer.forward(cfg, p, torch.from_numpy(toks))
    _close(got, want, LM_TOL)
    assert float(aux) == 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    want, wm = ref_tf.loss_fn(rcfg, rp, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    got, m = transformer.loss_fn(cfg, p, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    _close(got, want, TOL)
    _close(m["acc"], wm["acc"], TOL)


def test_prefill_then_decode_reproduces_the_forward_past_the_window():
    """The port against itself (``tests/test_decode_parity.py``'s check):
    a prefill of 80 tokens (past hymba-smoke's window of 64: a ring
    buffer) then 16 decode steps give the logits of one forward over all
    96 positions, which applies the same window; the mamba state carries
    the whole history on both paths."""
    _, _, cfg, p = _models(seed=5)
    b, s_pre, s = 2, 80, 96
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    feats, _ = transformer.forward(cfg, p, toks)
    full = feats @ transformer.lm_head_weight(cfg, p)
    logits, cache = transformer.prefill(cfg, p, toks[:, :s_pre])
    assert cache["attn"]["slot_pos"].shape[-1] == cfg.sliding_window
    _close(logits, full[:, s_pre - 1], LM_TOL)
    for t in range(s_pre, s):
        pos = torch.full((b,), t, dtype=torch.int32)
        logits, cache = transformer.decode_step(cfg, p, cache,
                                                toks[:, t:t + 1], pos)
        _close(logits, full[:, t], LM_TOL, f"position {t}")
