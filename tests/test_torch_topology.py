"""Topologies from replayed permutations equal the reference's exactly."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import topology as ref_topology
from repro_torch.core import topology
from torch_caps import perms_from_key

torch.set_num_threads(1)


@pytest.mark.parametrize("n,r", [(8, 2), (8, 3), (32, 4), (9, 5), (5, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_regular_and_mixing_match_the_reference(n, r, seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 100 * n + r)
    want = np.asarray(ref_topology.random_regular(key, n, r))
    got = topology.random_regular(perms_from_key(key, n, r), n, r)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        topology.mixing_matrix(got).numpy(),
        np.asarray(ref_topology.mixing_matrix(want)))
    np.testing.assert_array_equal(topology.degrees(got).numpy(),
                                  np.asarray(ref_topology.degrees(want)))


def test_fully_connected_matches_the_reference():
    np.testing.assert_array_equal(
        topology.fully_connected(6).numpy(),
        np.asarray(ref_topology.fully_connected(6)))


def test_draw_perms_are_permutations():
    perms = topology.draw_perms(torch.Generator().manual_seed(0), 10, 5)
    assert perms.shape == (topology.n_perms(5), 10) == (3, 10)
    for p in perms:
        assert sorted(p.tolist()) == list(range(10))
    a = topology.random_regular(perms, 10, 5)
    assert torch.equal(a, a.T) and float(a.diagonal().abs().sum()) == 0.0
    assert int(a.sum(1).max()) <= 5


@pytest.mark.parametrize("r", [0, 8])
def test_degree_out_of_range_raises(r):
    with pytest.raises(ValueError, match="out of range"):
        topology.random_regular(torch.zeros((1, 8), dtype=torch.long), 8, r)


def test_wrong_number_of_perms_raises():
    with pytest.raises(ValueError, match="perms must be"):
        topology.random_regular(torch.zeros((1, 8), dtype=torch.long), 8, 4)


@pytest.mark.parametrize("n,r", [(8, 2), (8, 3), (8, 4), (5, 1), (9, 8)])
def test_ring_matches_the_reference(n, r):
    got = topology.ring(n, r)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_topology.ring(n, r)))


@pytest.mark.parametrize("r", [0, 8])
def test_ring_degree_out_of_range_raises(r):
    with pytest.raises(ValueError, match="out of range"):
        topology.ring(8, r)


def test_weighted_mixing_matches_the_reference():
    """DAC's weights: similarities on a sampled graph, one node isolated
    (its row is the self edge alone)."""
    rng = np.random.default_rng(0)
    adj = (rng.random((7, 7)) < 0.4).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0.0)
    adj[3, :] = adj[:, 3] = 0.0
    weights = np.maximum(rng.random((7, 7)).astype(np.float32), 1e-6)
    got = topology.weighted_mixing(torch.from_numpy(adj),
                                   torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref_topology.weighted_mixing(adj, weights)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-6)
