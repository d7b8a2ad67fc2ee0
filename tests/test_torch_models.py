"""GN-LeNet in the port against the reference on the same numpy inputs:
layers, logits and ``loss_fn`` gradients, fp32.

Tolerance: 1e-5 relative/absolute on activations and logits — the two
frameworks sum convolutions and reductions in different orders, which at
fp32 moves values by a few ulps of their magnitude; gradients, which add
one more such pass, 2e-5 relative of the leaf's largest entry."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.models import cnn as ref_cnn
from repro.models import layers as ref_layers
from repro_torch.configs import facade_paper
from repro_torch.core.bindings import make_binding
from repro_torch.interop import params_from_jax, params_to_jax
from repro_torch.models import cnn, layers
from repro_torch.models.base import CNNConfig

torch.set_num_threads(1)
TOL = 1e-5


def _inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, cfg.image_size, cfg.image_size, cfg.channels))
    y = rng.integers(0, cfg.n_classes, size=(b,))
    return x.astype(np.float32), y.astype(np.int32)


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        ref_cnn.init_params(cfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm_nhwc(groups):
    rng = np.random.default_rng(groups)
    x = rng.normal(size=(3, 5, 6, 8)).astype(np.float32) * 2 + 0.5
    g = rng.normal(size=(8,)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    want = ref_layers.group_norm(jnp.asarray(x), g, b, groups)
    got = layers.group_norm(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(b), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent(masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(4, 7)).astype(np.int32)
    mask = (rng.random((4, 7)) > 0.3).astype(np.float32) if masked else None
    want = ref_layers.softmax_xent(jnp.asarray(logits), labels, mask)
    got = layers.softmax_xent(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_lenet_features_and_logits(smoke):
    rcfg, cfg = ref_configs.lenet(smoke), facade_paper.lenet(smoke)
    params = _ref_params(rcfg)
    x, _ = _inputs(cfg, 4, 2)
    want_f = ref_cnn.lenet_features(rcfg, params, jnp.asarray(x))
    want = ref_cnn.forward(rcfg, params, jnp.asarray(x))
    p = params_from_jax(params)
    got_f = cnn.lenet_features(cfg, p, torch.from_numpy(x))
    got = cnn.forward(cfg, p, torch.from_numpy(x))
    assert got_f.shape == want_f.shape == (4, (cfg.image_size // 8) ** 2
                                           * cfg.width)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_loss_fn_value_and_gradients(smoke):
    rcfg, cfg = ref_configs.lenet(smoke), facade_paper.lenet(smoke)
    params = _ref_params(rcfg, seed=3)
    x, y = _inputs(cfg, 8, 4)
    (want_l, want_aux), want_g = jax.value_and_grad(
        lambda p: ref_cnn.loss_fn(rcfg, p, {"x": jnp.asarray(x), "y": y}),
        has_aux=True)(params)
    p = jax.tree.map(lambda t: t.requires_grad_(), params_from_jax(params))
    loss, aux = cnn.loss_fn(cfg, p, {"x": torch.from_numpy(x),
                                     "y": torch.from_numpy(y).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_l), rtol=TOL)
    assert aux["acc"].item() == float(want_aux["acc"])
    got_g = params_to_jax(jax.tree.map(lambda t: t.grad, p))
    for g, w in zip(jax.tree.leaves(got_g), jax.tree.leaves(want_g)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-3))


def test_node_stacked_loss_is_the_sum_of_the_nodes_own_losses():
    """The binding's node-batched loss (one grouped conv for all nodes)
    equals each node's own ``loss_fn``, and so do its gradients."""
    cfg = facade_paper.lenet(smoke=True)
    binding = make_binding(cfg)
    nodes = [cnn.init_lenet(cfg, torch.Generator().manual_seed(s))
             for s in range(3)]
    stacked = jax.tree.map(lambda *l: torch.stack(l).requires_grad_(),
                           *nodes)
    xs, ys = zip(*(_inputs(cfg, 5, 10 + i) for i in range(3)))
    x = torch.from_numpy(np.stack(xs))
    y = torch.from_numpy(np.stack(ys)).long()
    total = binding.loss(stacked, {"x": x, "y": y})
    total.backward()
    for i, params in enumerate(nodes):
        params = jax.tree.map(lambda t: t.clone().requires_grad_(), params)
        loss, _ = cnn.loss_fn(cfg, params, {"x": x[i], "y": y[i]})
        loss.backward()
        for a, b in zip(jax.tree.leaves(stacked), jax.tree.leaves(params)):
            np.testing.assert_allclose(a.grad[i].numpy(), b.grad.numpy(),
                                       rtol=1e-5, atol=1e-6)
    want = sum(cnn.loss_fn(cfg, p, {"x": x[i], "y": y[i]})[0].item()
               for i, p in enumerate(nodes))
    np.testing.assert_allclose(total.item(), want, rtol=1e-6)


def test_other_model_kinds_are_refused():
    with pytest.raises(NotImplementedError, match="vgg"):
        make_binding(CNNConfig(name="x", kind="vgg"))
