"""The port's netsim plumbing of the round functions (``core/netwire.py``)
and the five round functions under network conditions, against the
reference's, on the CPU.

The conditions come from the reference's own uniforms
(``torch_caps.JaxDraws``), so both sides see the same masks, stale marks
and tiers. Bytes are exact (the float32 count of delivering edges times
the payload); simulated seconds within 1e-6 relative; the state after one
round (H SGD steps) within 1e-4 of each leaf's scale, as
``tests/test_torch_round.py`` holds the ideal-medium rounds. Under
``async-edge`` the gossip buffer differs from the fresh state, so the
stale nodes' neighbours really mix (and DAC really scores) the published
snapshot."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import netsim as ref_netsim
from repro.configs import facade_paper as ref_configs
from repro.core import facade as ref_facade
from repro.core import netwire as ref_netwire
from repro.core import topology as ref_topology
from repro.core.baselines import dac as ref_dac
from repro.core.baselines import deprl as ref_deprl
from repro.core.baselines import dpsgd as ref_dpsgd
from repro.core.baselines import el as ref_el
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_baseline_state as ref_init_baseline
from repro.core.state import init_facade_state as ref_init_facade
from repro.data import pipeline as ref_pipeline
from repro_torch import netsim
from repro_torch.configs import facade_paper
from repro_torch.core import facade, netwire, topology
from repro_torch.core.baselines import dac, deprl, dpsgd, el
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import BaselineState, FacadeState
from repro_torch.data import pipeline, synthetic
from repro_torch.interop import params_from_jax, params_to_jax
from test_torch_netsim import ref_net
from torch_caps import JaxDraws, perms_from_key

torch.set_num_threads(1)
N, K, DEG, H, B, LR = 8, 2, 3, 2, 4, 0.05
CID = np.array([0, 1, 0, 1, 1, 0, 0, 1], np.int32)
PRESETS = ("hostile", "async-edge")


@pytest.fixture(scope="module")
def setup():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=4, seed=3)
    ds = synthetic.make_clustered_data(spec, (5, 3), ("rot0", "rot180"))
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


def _conds(name: str):
    """A round of ``name`` from the reference's uniforms where some nodes
    are offline (if the preset has churn) and, under async gossip, some
    stay stale with a fresh buffer:
    ``(port conds, reference conds, tiers)`` with the stale mask set
    under async gossip."""
    cfg = netsim.NetworkConfig.preset(name)
    rcfg = ref_net(cfg)
    sched = netsim.NetSchedule(cfg, N, JaxDraws(0))
    chan, rchan = sched.init_channel("cpu"), ref_netsim.init_channel(rcfg, N)
    age = jnp.zeros((N,), jnp.int32)
    for rnd in range(40):
        nd = sched.round(rnd)
        conds, chan = netsim.advance_conditions(cfg, nd, chan)
        want, rchan = ref_netsim.advance_conditions(rcfg, N, rnd, rchan)
        if cfg.async_gossip:
            gossip = netsim.GossipState({}, torch.zeros(N, dtype=torch.int32))
            conds, _ = netsim.apply_async(cfg, conds, gossip)
            want, _ = ref_netsim.apply_async(
                rcfg, want, ref_netsim.GossipState({}, age))
        stale = 0 if conds.stale is None else int(conds.stale.sum())
        offline = N - int(conds.active.sum())
        if (N - offline >= 2 and (offline > 0 or cfg.churn_rate == 0)
                and (stale > 0 or not cfg.async_gossip)):
            return conds, want, nd.tiers
    raise AssertionError(f"no round of {name} fits")


@pytest.mark.parametrize("name", PRESETS + ("edge-v2", "core-edge"))
def test_comm_info_and_round_seconds_equal_the_references(name):
    """Bytes of the delivering edges (stale senders' rows left out) and the
    round's seconds (stale nodes out of the gating set), from one random
    regular topology masked by the round's conditions."""
    conds, want, tiers = _conds(name)
    cfg, rcfg = netsim.NetworkConfig.preset(name), ref_net(
        netsim.NetworkConfig.preset(name))
    key = jax.random.PRNGKey(3)
    adj = netwire.masked_topology(conds, topology.random_regular(
        perms_from_key(key, N, DEG), N, DEG))
    want_adj = ref_netwire.masked_topology(
        want, ref_topology.random_regular(key, N, DEG))
    np.testing.assert_array_equal(adj.numpy(), np.asarray(want_adj))
    for payload in (49568, 3_000_001):
        info = netwire.comm_info(conds, adj, payload, N * DEG)
        winfo = ref_netwire.comm_info(want, want_adj, payload, N * DEG)
        assert info["round_bytes"].dtype == torch.float32
        assert float(info["round_bytes"]) == float(winfo["round_bytes"])
        secs = netwire.round_seconds(cfg, info, conds, H, tiers=tiers)
        wsecs = ref_netwire.round_seconds(rcfg, winfo, want, H)
        np.testing.assert_allclose(float(secs), float(wsecs), rtol=1e-6)
    if conds.stale is not None:
        full = adj.sum() * payload
        assert float(info["round_bytes"]) < float(full)
    nominal = netwire.comm_info(None, adj, 100, N * DEG)
    assert nominal["round_bytes"] == float(N * DEG * 100)
    assert netwire.round_seconds(None, nominal, conds, H) == 0.0


def _close(got_tree, want_tree, lead, rel=1e-4):
    got = params_to_jax(got_tree, lead=lead)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want_tree),
                    strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-3))


def _to_port(tree, lead):
    return params_from_jax(jax.tree.map(np.asarray, tree), lead=lead)


def _check_info(name, conds, want, tiers, pinfo, info):
    cfg = netsim.NetworkConfig.preset(name)
    assert float(pinfo["round_bytes"]) == float(info["round_bytes"])
    np.testing.assert_allclose(
        float(netwire.round_seconds(cfg, pinfo, conds, H, tiers=tiers)),
        float(ref_netwire.round_seconds(ref_net(cfg), info, want, H)),
        rtol=1e-6)


@pytest.mark.parametrize("name", PRESETS)
def test_facade_round_under_conditions_equals_the_references(setup, name):
    rb, pb, ref_batches, batches = setup
    conds, want, tiers = _conds(name)
    st = ref_init_facade(rb, jax.random.PRNGKey(1), N, K, head_jitter=0.05)
    st = st._replace(cluster_id=jnp.asarray(CID))
    pub = None
    if conds.stale is not None:
        pub = {"cores": jax.tree.map(lambda l: 0.5 * l, st.cores),
               "heads": jax.tree.map(lambda l: 0.9 * l, st.heads),
               "cluster_id": jnp.asarray(1 - CID)}
    fcfg = ref_facade.FacadeConfig(n_nodes=N, k=K, degree=DEG,
                                   local_steps=H, lr=LR)
    new, info = jax.jit(functools.partial(ref_facade.facade_round, fcfg,
                                          rb))(st, ref_batches, net=want,
                                               gossip=pub)
    perms = perms_from_key(jax.random.split(st.rng)[1], N, DEG)
    port = FacadeState(cores=_to_port(st.cores, 1),
                       heads=_to_port(st.heads, 2),
                       cluster_id=torch.from_numpy(CID).long(), round=0)
    ppub = None if pub is None else {
        "cores": _to_port(pub["cores"], 1), "heads": _to_port(pub["heads"], 2),
        "cluster_id": torch.from_numpy(1 - CID).long()}
    got, pinfo = facade.facade_round(
        facade.FacadeConfig(n_nodes=N, k=K, degree=DEG, lr=LR), pb, port,
        batches, perms, net=conds, gossip=ppub)
    losses = np.asarray(info["selection_losses"])
    np.testing.assert_allclose(pinfo["selection_losses"].numpy(), losses,
                               rtol=1e-5, atol=1e-5)
    apart = np.abs(losses[:, 0] - losses[:, 1]) > 1e-4
    np.testing.assert_array_equal(got.cluster_id.numpy()[apart],
                                  np.asarray(new.cluster_id)[apart])
    off = conds.active.numpy() == 0
    np.testing.assert_array_equal(got.cluster_id.numpy()[off], CID[off])
    _check_info(name, conds, want, tiers, pinfo, info)
    _close(got.cores, new.cores, lead=1)
    _close(got.heads, new.heads, lead=2)


BASELINES = {
    "el": (el.ELConfig, el.el_round, ref_el.ELConfig, ref_el.el_round),
    "dpsgd": (dpsgd.DpsgdConfig, dpsgd.dpsgd_round, ref_dpsgd.DpsgdConfig,
              ref_dpsgd.dpsgd_round),
    "deprl": (deprl.DeprlConfig, deprl.deprl_round, ref_deprl.DeprlConfig,
              ref_deprl.deprl_round),
    "dac": (dac.DACConfig, dac.dac_round, ref_dac.DACConfig,
            ref_dac.dac_round),
}


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("algo", sorted(BASELINES))
def test_baseline_round_under_conditions_equals_the_references(setup, algo,
                                                               name):
    rb, pb, ref_batches, batches = setup
    cfg_cls, round_fn, ref_cfg_cls, ref_round = BASELINES[algo]
    conds, want, tiers = _conds(name)
    extra = None
    if algo == "dac":       # non-trivial similarities, so the ranks matter
        sim = np.random.default_rng(2).random((N, N)).astype(np.float32)
        extra = {"sim": jnp.asarray(sim)}
    st = ref_init_baseline(rb, jax.random.PRNGKey(3), N, extra=extra)
    pub = (None if conds.stale is None
           else jax.tree.map(lambda l: 0.5 * l, st.params))
    rcfg = ref_cfg_cls(n_nodes=N, degree=DEG, local_steps=H, lr=LR)
    new, info = jax.jit(functools.partial(ref_round, rcfg, rb))(
        st, ref_batches, net=want, gossip=pub)
    port = BaselineState(params=_to_port(st.params, 1), round=0,
                         extra=None if extra is None else {
                             "sim": torch.from_numpy(sim)})
    ppub = None if pub is None else _to_port(pub, 1)
    pcfg = cfg_cls(n_nodes=N, degree=DEG, lr=LR)
    draw = ()
    if algo == "el":
        draw = (perms_from_key(jax.random.split(st.rng)[1], N, DEG),)
    elif algo == "dac":
        draw = (torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.split(st.rng)[1], (N, N)))),)
    got, pinfo = round_fn(pcfg, pb, port, batches, *draw, net=conds,
                          gossip=ppub)
    _check_info(name, conds, want, tiers, pinfo, info)
    _close(got.params, new.params, lead=1)
    if algo == "dac":
        np.testing.assert_allclose(got.extra["sim"].numpy(),
                                   np.asarray(new.extra["sim"]), rtol=1e-5,
                                   atol=0)
        off = conds.active.numpy() == 0
        np.testing.assert_array_equal(got.extra["sim"].numpy()[off],
                                      sim[off])
