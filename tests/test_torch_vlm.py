"""The VLM family (llava-next) against the JAX reference on the CPU, on the
llava-next-34b smoke config (fp32) with the reference's parameters carried
across by ``interop.lm_params_from_jax`` and the same numpy-seeded image
embeddings (the vision tower is a stub on both sides): ``forward`` over
the image prefix and the tokens, ``loss_fn`` (the text positions only)
with its gradients, ``prefill`` and ``decode_step`` at positions after the
image prefix, and the LM binding's features without the image positions.

Tolerances as ``test_torch_lm.py`` (logits 1e-4) and
``test_torch_facade_lm.py`` (loss and metrics 1e-5, gradients 1e-4)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs  # noqa: F401  (registry)
import repro_torch.configs  # noqa: F401  (registry)
from repro.core.bindings import make_binding as ref_make_binding
from repro.models import api as ref_api
from repro.models import transformer as ref_tf
from repro.models.base import get_config as ref_get_config
from repro_torch.configs import llava_next_34b
from repro_torch.core.bindings import make_binding
from repro_torch.interop import lm_params_from_jax, lm_params_to_jax
from repro_torch.models import transformer
from repro_torch.models.base import get_config
from repro_torch.tree import tree_map

torch.set_num_threads(1)
ARCH = "llava-next-34b"
LM_TOL, VALUE_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-4


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _models(seed=3):
    rcfg, cfg = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    rp = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, rp, cfg, lm_params_from_jax(rp)


def _img(cfg, b, seed=4):
    return (0.5 * np.random.default_rng(seed).normal(
        size=(b, cfg.n_image_tokens, cfg.d_model))).astype(np.float32)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_is_the_references_with_its_anyres_tiling():
    cfg = get_config(ARCH)
    assert cfg.arch_type == "vlm"
    assert cfg.n_image_tokens == llava_next_34b.ANYRES_TILES * \
        llava_next_34b.PATCHES_PER_TILE == 2880
    assert get_config(ARCH, smoke=True).n_image_tokens == 16


def test_forward_over_the_image_prefix_matches_the_reference():
    """Features of every position, image ones first; the image embeddings
    are cast to the embedding dtype; without them the text alone."""
    rcfg, rp, cfg, p = _models()
    toks, img = _tokens(cfg, 2, 20), _img(cfg, 2)
    for im in (img, None):
        want, _ = ref_tf.forward(rcfg, rp, jnp.asarray(toks),
                                 img_embeds=None if im is None
                                 else jnp.asarray(im))
        got, _ = transformer.forward(cfg, p, torch.from_numpy(toks),
                                     img_embeds=None if im is None
                                     else torch.from_numpy(im))
        assert got.shape == want.shape
        _close(got, want, LM_TOL)
    bf = cfg.replace(dtype="bfloat16")
    x, pos = transformer.embed_inputs(
        bf, tree_map(lambda t: t.bfloat16(), p), torch.from_numpy(toks),
        torch.from_numpy(img))
    assert x.dtype == torch.bfloat16 and x.shape[1] == 16 + 20
    np.testing.assert_array_equal(pos[0].numpy(), np.arange(36))


def test_loss_fn_scores_the_text_positions_as_the_reference():
    rcfg, rp, cfg, _ = _models(seed=4)
    rng = np.random.default_rng(2)
    toks = _tokens(cfg, 2, 25, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((2, 24)) > 0.2).astype(np.float32),
             "img_embeds": _img(cfg, 2)}
    (want, want_m), want_g = jax.value_and_grad(
        lambda q: ref_tf.loss_fn(rcfg, q, {k: jnp.asarray(v) for k, v in
                                           batch.items()}),
        has_aux=True)(rp)
    params = tree_map(lambda t: t.requires_grad_(), lm_params_from_jax(rp))
    got, got_m = transformer.loss_fn(cfg, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    _close(got.item(), want, VALUE_TOL)
    for name in ("ce", "aux", "acc"):
        _close(got_m[name].item(), want_m[name], VALUE_TOL, name)
    for g, w in zip(jax.tree.leaves(lm_params_to_jax(
            tree_map(lambda t: t.grad, params))),
            jax.tree.leaves(want_g), strict=True):
        _close(g, w, GRAD_TOL)


def test_prefill_and_decode_after_the_image_prefix_match_the_reference():
    """Prefill over 16 image positions and 20 tokens, then 8 decode steps
    at positions ``n_img + 20 ..``, as a caller continues after an image
    prefix; logits and the final cache."""
    rcfg, rp, cfg, p = _models()
    b, s_pre, s_gen = 2, 20, 8
    toks, img = _tokens(cfg, b, s_pre + s_gen), _img(cfg, b)
    n_img = cfg.n_image_tokens
    want, rcache = ref_tf.prefill(rcfg, rp, jnp.asarray(toks[:, :s_pre]),
                                  img_embeds=jnp.asarray(img),
                                  cache_extra=s_gen)
    got, cache = transformer.prefill(cfg, p, torch.from_numpy(toks[:, :s_pre]),
                                     img_embeds=torch.from_numpy(img),
                                     cache_extra=s_gen)
    _close(got, want, LM_TOL, "prefill")
    assert cache["k"].shape[2] == n_img + s_pre + s_gen
    for t in range(s_pre, s_pre + s_gen):
        pos = np.full((b,), n_img + t, np.int32)
        want, rcache = ref_tf.decode_step(rcfg, rp, rcache,
                                          jnp.asarray(toks[:, t:t + 1]),
                                          jnp.asarray(pos))
        got, cache = transformer.decode_step(
            cfg, p, cache, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos))
        _close(got, want, LM_TOL, f"decode at {t}")
    for x, y in zip(jax.tree.leaves(cache), jax.tree.leaves(rcache)):
        if x.dtype == torch.int32:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            _close(x, y, LM_TOL)


def test_prefill_then_decode_reproduces_the_forward():
    """The port against itself: prefill over the image prefix and 12
    tokens, then decode, give one forward's logits at each position."""
    _, _, cfg, p = _models(seed=6)
    b, s = 2, 20
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=7))
    img = torch.from_numpy(_img(cfg, b, seed=8))
    n_img = cfg.n_image_tokens
    feats, _ = transformer.forward(cfg, p, toks, img_embeds=img)
    full = feats @ transformer.lm_head_weight(cfg, p)
    logits, cache = transformer.prefill(cfg, p, toks[:, :12],
                                        img_embeds=img, cache_extra=8)
    _close(logits, full[:, n_img + 11], LM_TOL)
    for t in range(12, s):
        logits, cache = transformer.decode_step(
            cfg, p, cache, toks[:, t:t + 1],
            torch.full((b,), n_img + t, dtype=torch.int32))
        _close(logits, full[:, n_img + t], LM_TOL, f"position {t}")


def test_lm_binding_features_drop_the_image_positions():
    """``features`` passes each node's ``img_embeds`` and returns the text
    positions only, as the reference binding's; ``node_losses`` is each
    node's ``loss_fn`` with its image prefix."""
    rcfg, _, cfg, _ = _models()
    rb, pb = ref_make_binding(rcfg), make_binding(cfg)
    rp = rb.init(jax.random.PRNGKey(1))
    params = lm_params_from_jax(rp)
    n = 2
    toks = _tokens(cfg, n * 2, 13, seed=9).reshape(n, 2, 13)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "mask": np.ones((n, 2, 12), np.float32),
             "img_embeds": _img(cfg, n * 2).reshape(
                 n, 2, cfg.n_image_tokens, cfg.d_model)}
    stacked = tree_map(lambda t: torch.stack([t] * n), params)
    core = {k: v for k, v in stacked.items() if k not in pb.head_keys}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    feats = pb.features(core, tb)
    assert feats.shape == (n, 2, 12, cfg.d_model)
    rcore = {k: v for k, v in rp.items() if k not in rb.head_keys}
    for i in range(n):
        node = {k: jnp.asarray(v[i]) for k, v in batch.items()}
        _close(feats[i], rb.features(rcore, node), LM_TOL)
        _close(pb.node_losses(stacked, tb)[i].item(), rb.loss(rp, node),
               VALUE_TOL)
