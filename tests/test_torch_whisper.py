"""The encoder-decoder family (whisper) against the JAX reference on the
CPU, on the whisper-tiny smoke config (fp32) with the reference's
parameters carried across by ``interop.lm_params_from_jax``.

Tolerances: ``sinusoids`` two fp32 ulps of its largest angle,
``layer_norm`` and ``gelu_mlp`` 1e-5 (one op, fp32); ``encode``, ``forward``, decode logits and caches 1e-4
(a whole model, as ``test_torch_lm.py``); ``loss_fn`` and its metrics
1e-5, gradients 1e-4 (``test_torch_facade_lm.py``'s); the binding's
step-2c losses 1e-5 with equal argmins. Also: the port's decode steps
reproduce its teacher-forced forward, the init's tree and scales, and the
server's refusal of an encoder-decoder config."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
import repro_torch.configs  # noqa: F401  (registry)
from repro.core.bindings import make_binding as ref_make_binding
from repro.models import api as ref_api
from repro.models import layers as ref_layers
from repro.models import whisper as ref_wh
from repro.models.base import get_config as ref_get_config
from repro_torch.core.bindings import make_binding
from repro_torch.interop import lm_params_from_jax, lm_params_to_jax
from repro_torch.kernels.head_select import head_losses
from repro_torch.launch import serve as port_serve
from repro_torch.models import api, layers, whisper
from repro_torch.models.base import get_config
from repro_torch.tree import tree_map

torch.set_num_threads(1)
ARCH = "whisper-tiny"
OP_TOL, VALUE_TOL, LM_TOL = 1e-5, 1e-5, 1e-4


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _models(seed=3):
    rcfg, cfg = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    rp = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, rp, cfg, lm_params_from_jax(rp)


def _frames(cfg, b=2, seed=2):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _batch(cfg, b, s, seed, masked=0.2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) >= masked).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask,
            "frames": _frames(cfg, b, seed + 100)}


@pytest.mark.parametrize("length,channels", [(1500, 384), (32, 128), (7, 6)])
def test_sinusoids_match_the_reference(length, channels):
    """sin before cos, timescales over ``channels // 2 - 1``; within two
    fp32 ulps of the largest angle (about ``length`` radians), since an
    inverse timescale one bit off moves the angle by that much."""
    tol = 1e-6 + 2 * length * 2.0 ** -23
    _close(whisper.sinusoids(length, channels),
           ref_wh.sinusoids(length, channels), tol)


def test_layer_norm_and_gelu_mlp_match_the_reference():
    """``layer_norm`` with the biased variance (``jnp.var``) and
    ``gelu_mlp`` with ``jax.nn.gelu``'s default tanh approximation."""
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(2, 5, 16)) + 1).astype(np.float32)
    g, b = (1 + 0.1 * rng.normal(size=(2, 16))).astype(np.float32)
    _close(layers.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                             torch.from_numpy(b)),
           ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                 jnp.asarray(b)), OP_TOL)
    rp = ref_layers.init_gelu_mlp(jax.random.PRNGKey(1), 16, 48, jnp.float32)
    rp = dict(rp, b_in=jnp.asarray(rng.normal(size=48).astype(np.float32)))
    want = ref_layers.gelu_mlp(rp, jnp.asarray(x))
    got = layers.gelu_mlp(lm_params_from_jax(rp), torch.from_numpy(x))
    _close(got, want, OP_TOL)
    exact = torch.nn.functional.gelu(torch.from_numpy(x) @ torch.tensor(
        np.asarray(rp["w_in"])) + torch.tensor(np.asarray(rp["b_in"])))
    assert not torch.allclose(exact, torch.nn.functional.gelu(
        exact, approximate="tanh"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_follows_the_reference(dtype):
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
    assert api.is_encdec(cfg) and "lm_head" not in params     # tied


def test_encode_and_forward_match_the_reference():
    rcfg, rp, cfg, p = _models()
    fr = _frames(cfg)
    _close(whisper.encode(cfg, p, torch.from_numpy(fr)),
           ref_wh.encode(rcfg, rp, jnp.asarray(fr)), LM_TOL)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    for final in (True, False):
        want, _ = ref_wh.forward(rcfg, rp, jnp.asarray(toks),
                                 jnp.asarray(fr), apply_final_norm=final)
        got, aux = whisper.forward(cfg, p, torch.from_numpy(toks),
                                   torch.from_numpy(fr),
                                   apply_final_norm=final)
        _close(got, want, LM_TOL)
        assert float(aux) == 0.0


def test_loss_fn_value_and_gradients_match_the_reference():
    """``api.loss_fn`` dispatches to ``whisper.loss_fn``; value and
    metrics 1e-5, every gradient 1e-4 against ``jax.grad``."""
    rcfg, rp, cfg, _ = _models(seed=4)
    batch = _batch(cfg, 2, 24, seed=1)
    (want, want_m), want_g = jax.value_and_grad(
        lambda p: ref_api.loss_fn(rcfg, p, {k: jnp.asarray(v) for k, v in
                                            batch.items()}),
        has_aux=True)(rp)
    params = tree_map(lambda t: t.requires_grad_(), lm_params_from_jax(rp))
    got, got_m = api.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    got.backward()
    _close(got.item(), want, VALUE_TOL)
    for name in ("ce", "aux", "acc"):
        _close(got_m[name].item(), want_m[name], VALUE_TOL, name)
    got_g = lm_params_to_jax(tree_map(lambda t: t.grad, params))
    for g, w in zip(jax.tree.leaves(got_g), jax.tree.leaves(want_g),
                    strict=True):
        _close(g, w, 1e-4)


def test_init_cache_and_decode_match_the_reference():
    """``init_cache`` (the encoder's cross k, v a layer, an empty self
    cache) and 12 decode steps into a 8-slot cache (positions wrap past
    it), then positions past ``max_decoder_len`` (clamped)."""
    rcfg, rp, cfg, p = _models()
    fr = _frames(cfg)
    b, cache_len = 2, 8
    rcache = ref_wh.init_cache(rcfg, rp, jnp.asarray(fr), b, cache_len)
    cache = whisper.init_cache(cfg, p, torch.from_numpy(fr), b, cache_len)
    assert jax.tree.structure(cache) == jax.tree.structure(rcache)
    for x, y in zip(jax.tree.leaves(cache), jax.tree.leaves(rcache)):
        assert tuple(x.shape) == y.shape
        _close(x, y, LM_TOL)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (b, 14)).astype(np.int32)
    positions = list(range(12)) + [cfg.max_decoder_len,
                                   cfg.max_decoder_len + 5]
    for i, t in enumerate(positions):
        pos = np.array([t, t + 1], np.int32)
        want, rcache = ref_wh.decode_step(rcfg, rp, rcache,
                                          jnp.asarray(toks[:, i:i + 1]),
                                          jnp.asarray(pos))
        got, cache = whisper.decode_step(cfg, p, cache,
                                         torch.from_numpy(toks[:, i:i + 1]),
                                         torch.from_numpy(pos))
        assert got.dtype == torch.float32
        _close(got, want, LM_TOL, f"step {i}")
    for x, y in zip(jax.tree.leaves(cache), jax.tree.leaves(rcache)):
        if x.dtype == torch.int32:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            _close(x, y, LM_TOL)


def test_decode_reproduces_the_teacher_forced_forward():
    """The port against itself: decode steps from ``init_cache`` over a
    prompt give, at each position, the logits of one ``forward``."""
    _, _, cfg, p = _models(seed=6)
    fr = torch.from_numpy(_frames(cfg, seed=7))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    feats, _ = whisper.forward(cfg, p, toks, fr)
    full = feats @ whisper.lm_head_weight(p)
    cache = whisper.init_cache(cfg, p, fr, 2, 16)
    for t in range(16):
        logits, cache = whisper.decode_step(
            cfg, p, cache, toks[:, t:t + 1],
            torch.full((2,), t, dtype=torch.int32))
        _close(logits, full[:, t], LM_TOL, f"position {t}")


def test_binding_loss_and_step_2c_operands_match_the_reference():
    """The whisper binding: each node's loss against the reference
    binding's ``loss`` (1e-5), and step 2c (each (node, head) stream
    LayerNorm'd with the head's ``g`` and ``b``, through the plain version
    of the head-select kernel) against its ``head_loss`` (1e-5, equal
    argmins)."""
    rcfg, _, cfg, _ = _models()
    rb, pb = ref_make_binding(rcfg), make_binding(cfg)
    assert pb.head_keys == rb.head_keys == ("final_norm", "lm_head")
    rp = rb.init(jax.random.PRNGKey(0))
    assert "lm_head" in rp
    n, k = 2, 3
    batches = [_batch(cfg, 2, 16, seed=10 + i) for i in range(n)]
    batch = {key: torch.from_numpy(np.stack([bt[key] for bt in batches]))
             for key in batches[0]}
    params = lm_params_from_jax(rp)
    stacked = tree_map(lambda t: torch.stack([t, t]), params)
    want = [float(rb.loss(rp, {key: jnp.asarray(v) for key, v in
                               bt.items()})) for bt in batches]
    _close(pb.node_losses(stacked, batch).numpy(), want, VALUE_TOL)

    core = {key: v for key, v in stacked.items() if key not in pb.head_keys}
    feats = pb.features(core, batch)
    want_f = [ref_wh.forward(rcfg, rp, jnp.asarray(bt["tokens"]),
                             jnp.asarray(bt["frames"]),
                             apply_final_norm=False)[0] for bt in batches]
    _close(feats.numpy(), np.stack(want_f), LM_TOL)
    rng = np.random.default_rng(5)
    d, v = cfg.d_model, cfg.vocab_size
    heads = {"final_norm": {
                 "g": (1 + 0.1 * rng.normal(size=(n, k, d))).astype(
                     np.float32),
                 "b": (0.1 * rng.normal(size=(n, k, d))).astype(np.float32)},
             "lm_head": (0.05 * rng.normal(size=(n, k, d, v))).astype(
                 np.float32)}
    want = np.array([[float(rb.head_loss(
        tree_map(lambda h: jnp.asarray(h[i, j]), heads),
        jnp.asarray(feats[i].numpy()),
        {key: jnp.asarray(x) for key, x in batches[i].items()}))
        for j in range(k)] for i in range(n)])
    f, w, labels = pb.select_operands(feats, tree_map(torch.from_numpy,
                                                      heads), batch)
    assert f.shape == (n * k, 32, d) and w.shape == (n * k, 1, d, v)
    got = head_losses(f, w, labels).reshape(n, k).numpy()
    _close(got, want, VALUE_TOL)
    np.testing.assert_array_equal(got.argmin(1), want.argmin(1))


def test_serve_refuses_an_encoder_decoder_config():
    """``serve`` and the CLI refuse it with the reference's message, the
    CLI before drawing any parameter."""
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(SystemExit, match="enc-dec serving"):
        port_serve.serve(cfg, {}, [np.array([1, 2], np.int32)], batch=1,
                         prompt_len=4, gen_len=2, device="cpu")
    with pytest.raises(SystemExit, match="enc-dec serving"):
        port_serve.main(["--arch", ARCH, "--device", "cpu"])
