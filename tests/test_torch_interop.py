"""Parameter conversion between the reference (HWIO convs, numpy) and the
port (OIHW convs, torch) round-trips exactly, for one model and for
node- and cluster-stacked trees."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_facade_state as ref_init_facade_state
from repro_torch.configs import facade_paper
from repro_torch.interop import params_from_jax, params_to_jax
from repro_torch.models import cnn

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("smoke", [True, False])
def test_single_model_round_trip_and_layout(smoke):
    ref = _np(ref_make_binding(ref_configs.lenet(smoke)).init(
        jax.random.PRNGKey(0)))
    port = params_from_jax(ref)
    w_ref, w_port = ref["conv2"]["w"], port["conv2"]["w"]
    assert w_port.shape == tuple(w_ref.shape[i] for i in (3, 2, 0, 1))
    # OIHW[o, i, h, w] == HWIO[h, w, i, o]
    np.testing.assert_array_equal(w_port.numpy()[5, 3, 2, 1],
                                  w_ref[2, 1, 3, 5])
    np.testing.assert_array_equal(port["fc"]["w"].numpy(), ref["fc"]["w"])
    _assert_tree_equal(params_to_jax(port), ref)


def test_port_init_has_the_reference_shapes_after_conversion():
    cfg = facade_paper.lenet()
    ref = _np(ref_make_binding(ref_configs.lenet()).init(
        jax.random.PRNGKey(0)))
    port = params_to_jax(cnn.init_lenet(cfg, torch.Generator().manual_seed(0)))
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for x, y in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        assert x.shape == y.shape and x.dtype == y.dtype


def test_stacked_state_round_trip():
    st = ref_init_facade_state(ref_make_binding(ref_configs.lenet(True)),
                               jax.random.PRNGKey(1), 3, 2, head_jitter=0.1)
    cores, heads = _np(st.cores), _np(st.heads)
    assert params_from_jax(cores, lead=1)["conv1"]["w"].shape[:3] == (3, 8, 3)
    _assert_tree_equal(params_to_jax(params_from_jax(cores, lead=1), lead=1),
                       cores)
    _assert_tree_equal(params_to_jax(params_from_jax(heads, lead=2), lead=2),
                       heads)
