"""One FACADE round (main and warmup), one EL round and the final
all-reduce of the port against the reference, from identical state,
batches and adjacency.

Tolerances: selection losses 1e-5 (fp32, one forward pass); parameters
after H SGD steps 1e-4 of each leaf's scale (the two frameworks' conv and
reduction orders differ by ulps, and H forward/backward passes compound
them). Round bytes and cluster ids away from loss near-ties are exact."""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.core import facade as ref_facade
from repro.core.baselines import el as ref_el
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_baseline_state as ref_init_baseline
from repro.core.state import init_facade_state as ref_init_facade
from repro.data import pipeline as ref_pipeline
from repro_torch.configs import facade_paper
from repro_torch.core import facade
from repro_torch.core.baselines import el
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import (BaselineState, FacadeState,
                                    init_baseline_state, init_facade_state)
from repro_torch.data import pipeline, synthetic
from repro_torch.interop import params_from_jax, params_to_jax
from torch_caps import perms_from_key

torch.set_num_threads(1)
N, K, DEG, H, B, LR = 6, 2, 3, 3, 8, 0.05
CID = np.array([0, 1, 0, 1, 1, 0], np.int32)


@pytest.fixture(scope="module")
def setup():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=4, seed=3)
    ds = synthetic.make_clustered_data(spec, (4, 2), ("rot0", "rot180"))
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    cfg = facade_paper.lenet(smoke=True).replace(n_classes=4)
    key = jax.random.PRNGKey(7)
    ref_batches = ref_pipeline.sample_round_batches(key, ds.train_x,
                                                    ds.train_y, H, B)
    idx = jax.random.randint(key, (N, H, B), 0, ds.train_x.shape[1])
    train_x, train_y = pipeline.place(ds, "cpu")
    batches = pipeline.sample_round_batches(torch.from_numpy(np.array(idx)),
                                            train_x, train_y)
    return ref_make_binding(rcfg), make_binding(cfg), ref_batches, batches


def _close(got_tree, want_tree, lead, rel=1e-4):
    got = params_to_jax(got_tree, lead=lead)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want_tree)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-3))


def _port_state(st):
    return FacadeState(
        cores=params_from_jax(jax.tree.map(np.asarray, st.cores), lead=1),
        heads=params_from_jax(jax.tree.map(np.asarray, st.heads), lead=2),
        cluster_id=torch.from_numpy(np.array(st.cluster_id)).long(),
        round=int(st.round))


@pytest.mark.parametrize("warmup", [False, True], ids=["main", "warmup"])
def test_facade_round_matches_the_reference(setup, warmup):
    rb, pb, ref_batches, batches = setup
    st = ref_init_facade(rb, jax.random.PRNGKey(1), N, K, head_jitter=0.05)
    st = st._replace(cluster_id=jax.numpy.asarray(CID))
    fcfg = ref_facade.FacadeConfig(n_nodes=N, k=K, degree=DEG,
                                   local_steps=H, lr=LR)
    want, info = jax.jit(functools.partial(ref_facade.facade_round, fcfg, rb,
                                           warmup=warmup))(st, ref_batches)
    perms = perms_from_key(jax.random.split(st.rng)[1], N, DEG)
    got, pinfo = facade.facade_round(
        facade.FacadeConfig(n_nodes=N, k=K, degree=DEG, lr=LR), pb, _port_state(st), batches, perms,
        warmup=warmup)

    losses = np.asarray(info["selection_losses"])
    np.testing.assert_allclose(pinfo["selection_losses"].numpy(), losses,
                               rtol=1e-5, atol=1e-5)
    apart = np.abs(losses[:, 0] - losses[:, 1]) > 1e-4
    assert apart.sum() >= N - 1          # the case is not all near-ties
    want_cid = np.asarray(want.cluster_id)
    np.testing.assert_array_equal(got.cluster_id.numpy()[apart],
                                  want_cid[apart])
    if warmup:
        assert not want_cid.any() and not got.cluster_id.any()
    assert pinfo["round_bytes"] == float(info["round_bytes"])
    assert got.round == int(want.round) == 1
    _close(got.cores, want.cores, lead=1)
    _close(got.heads, want.heads, lead=2)
    _close(facade.node_models(got), ref_facade.node_models(want, rb), lead=1)


def test_final_allreduce_matches_the_reference(setup):
    rb = setup[0]
    st = ref_init_facade(rb, jax.random.PRNGKey(2), N, K, head_jitter=0.1)
    st = st._replace(cluster_id=jax.numpy.asarray(CID))
    fcfg = ref_facade.FacadeConfig(n_nodes=N, k=K)
    want = ref_facade.final_allreduce(fcfg, st)
    got = facade.final_allreduce(facade.FacadeConfig(n_nodes=N, k=K),
                                 _port_state(st))
    _close(got.cores, want.cores, lead=1, rel=1e-6)
    _close(got.heads, want.heads, lead=2, rel=1e-6)


def test_el_round_matches_the_reference(setup):
    rb, pb, ref_batches, batches = setup
    st = ref_init_baseline(rb, jax.random.PRNGKey(3), N)
    cfg = ref_el.ELConfig(n_nodes=N, degree=DEG, local_steps=H, lr=LR)
    want, info = jax.jit(functools.partial(ref_el.el_round, cfg, rb))(
        st, ref_batches)
    perms = perms_from_key(jax.random.split(st.rng)[1], N, DEG)
    got, pinfo = el.el_round(
        el.ELConfig(n_nodes=N, degree=DEG, lr=LR), pb,
        BaselineState(params=params_from_jax(
            jax.tree.map(np.asarray, st.params), lead=1), round=0),
        batches, perms)
    assert pinfo["round_bytes"] == float(info["round_bytes"])
    assert got.round == 1
    _close(got.params, want.params, lead=1)


def test_identical_heads_make_round_one_a_near_tie(setup):
    """With ``head_jitter=0`` (the quickstart's default) a node's k heads
    differ after aggregation only by rounding, so each round-1 selection is
    a tie at the last ulp of the loss. The port's losses agree with the
    reference's to 1e-5 and every margin is below 1e-5 on both sides; which
    head wins such a tie depends on each framework's summation order."""
    rb, pb, ref_batches, batches = setup
    st = ref_init_facade(rb, jax.random.PRNGKey(1), N, K)
    fcfg = ref_facade.FacadeConfig(n_nodes=N, k=K, degree=DEG,
                                   local_steps=H, lr=LR)
    _, info = jax.jit(functools.partial(ref_facade.facade_round, fcfg,
                                        rb))(st, ref_batches)
    perms = perms_from_key(jax.random.split(st.rng)[1], N, DEG)
    _, pinfo = facade.facade_round(
        facade.FacadeConfig(n_nodes=N, k=K, degree=DEG, lr=LR), pb, _port_state(st), batches, perms)
    want = np.asarray(info["selection_losses"])
    got = pinfo["selection_losses"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(want[:, 0] - want[:, 1]).max() < 1e-5
    assert np.abs(got[:, 0] - got[:, 1]).max() < 1e-5


def test_round_bytes_formula():
    st = FacadeState(
        cores={"w": torch.zeros((N, 3, 5))},
        heads={"w": torch.zeros((N, K, 7)), "b": torch.zeros((N, K, 2))},
        cluster_id=torch.zeros(N, dtype=torch.long), round=0)
    assert facade.payload_bytes(st) == 4 * 15 + 4 * 9 + 4


def test_init_states_from_a_generator(setup):
    pb = setup[1]

    def facade_state(jitter):
        return init_facade_state(pb, N, K, head_jitter=jitter, device="cpu",
                                 generator=torch.Generator().manual_seed(0))

    st, again, jittered = facade_state(0.0), facade_state(0.0), \
        facade_state(0.1)
    w = st.heads["fc"]["w"]
    assert w.shape == (N, K, 32, 4) and st.cores["conv1"]["w"].shape == \
        (N, 8, 3, 3, 3)
    assert torch.equal(w, again.heads["fc"]["w"])               # seeded
    assert torch.equal(w[:, 0], w[:, 1]) and torch.equal(w[0], w[-1])
    jw = jittered.heads["fc"]["w"]
    assert not torch.equal(jw[:, 0], jw[:, 1]) and torch.equal(jw[0], jw[-1])
    assert st.cluster_id.tolist() == [0] * N and st.round == 0
    base = init_baseline_state(pb, N, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    assert torch.equal(base.params["conv1"]["w"], st.cores["conv1"]["w"])
    with pytest.raises(ValueError, match="Generator"):
        init_facade_state(pb, N, K, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        init_baseline_state(pb, N, device="cpu")
