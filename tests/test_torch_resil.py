"""The port's node faults (``repro_torch.resil``) and the robust guard,
unit by unit, against the reference's ``repro.resil`` on the CPU.

Each function gets the same numpy inputs on both sides; randomness comes
from the reference's own streams (``torch_caps.JaxDraws``: the crash,
restart and corruption uniforms and the payload noise, drawn through the
port's ``NetSchedule``). Masks, the crash chain and reset states are held
exactly; corrupted payloads, norms and guarded mixes within 1e-6. Also
pinned: the JAX leaf numbering of a FACADE payload (``cluster_id`` is
leaf 0, conv kernels drawn in HWIO and moved to OIHW), DAC's 1e9 score
for a non-finite peer, ``torch.argmin`` against ``jnp.argmin`` on rows
with NaN, and every ``FaultConfig`` field forking the engine's cache
key."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import netsim as ref_netsim
from repro import resil as ref_resil
from repro.configs import facade_paper as ref_configs
from repro.core import bindings as ref_bindings
from repro.core import facade as ref_facade
from repro.core import topology as ref_topology
from repro.core.state import init_facade_state as ref_init_facade
from repro_torch import netsim, resil
from repro_torch.configs import facade_paper
from repro_torch.core import facade, runner, topology
from repro_torch.core.bindings import gossip_mix, make_binding
from repro_torch.core.cache import EngineSpec
from repro_torch.core.state import FacadeState
from repro_torch.data import pipeline, synthetic
from repro_torch.interop import params_from_jax, params_to_jax
from repro_torch.resil import FaultConfig
from repro_torch.tree import tree_leaves, tree_map
from test_torch_netsim import ref_net
from torch_caps import JaxDraws

torch.set_num_threads(1)
N = 12
NAN_FAULTS = FaultConfig(crash_rate=0.3, restart_rate=0.5, corrupt_rate=0.3,
                         corrupt_mode="nan")
RESET_FAULTS = FaultConfig(crash_rate=0.4, restart_rate=0.6,
                           restart_mode="reset")
NOISE_FAULTS = FaultConfig(crash_rate=0.3, restart_rate=0.5,
                           corrupt_rate=0.3)


def _net(faults, preset="edge-v2"):
    return netsim.NetworkConfig.preset(preset, faults=faults)


def _np(t):
    return np.asarray(t.detach().cpu().numpy())


# ------------------------------------------------------ the config ------
def test_fault_config_is_the_references():
    """Same fields, defaults and validation as ``repro.resil``."""
    assert ([(f.name, f.default) for f in dataclasses.fields(FaultConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(ref_resil.FaultConfig)])
    assert resil.RESTART_MODES == ref_resil.RESTART_MODES
    assert resil.CORRUPT_MODES == ref_resil.CORRUPT_MODES
    for bad in ({"restart_mode": "reboot"}, {"corrupt_mode": "bitflip"},
                {"crash_rate": 1.5}, {"corrupt_rate": -0.1},
                {"restart_rate": 2.0}, {"clip": 0.0}):
        with pytest.raises(ValueError):
            FaultConfig(**bad)
        with pytest.raises(ValueError):
            ref_resil.FaultConfig(**bad)
    hash(_net(NAN_FAULTS))                 # frozen: an engine cache key


def test_guard_and_init_state_gate_as_the_references():
    for fc in (None, FaultConfig(), FaultConfig(corrupt_rate=0.5),
               FaultConfig(corrupt_rate=0.5, robust=False),
               FaultConfig(corrupt_rate=0.5, clip=2.0)):
        want = ref_resil.guard_of(
            None if fc is None else ref_resil.FaultConfig(
                **dataclasses.asdict(fc)))
        got = resil.guard_of(fc)
        assert (got is None) == (want is None)
        if got is not None:
            assert got.clip == want.clip
    state = {"p": torch.ones((4, 2))}
    for fc in (None, FaultConfig(), FaultConfig(corrupt_rate=0.5),
               FaultConfig(crash_rate=0.5),
               FaultConfig(crash_rate=0.5, restart_mode="reset")):
        net = netsim.NetworkConfig.preset("edge-churn", faults=fc)
        want = ref_resil.init_state(ref_net(net), 4,
                                    state={"p": jnp.ones((4, 2))})
        got = resil.init_state(net, 4, state)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(_np(got.down), want.down)
            assert (got.init is None) == (want.init is None)
            if got.init is not None:      # a copy, never the state itself
                assert got.init["p"] is not state["p"]
                assert torch.equal(got.init["p"], state["p"])
    with pytest.raises(ValueError, match="reset"):
        resil.init_state(_net(RESET_FAULTS), 4)


# ------------------------------------------------------ the chain -------
@pytest.mark.parametrize("faults", [NAN_FAULTS, RESET_FAULTS, NOISE_FAULTS,
                                    FaultConfig(crash_rate=1.0,
                                                restart_rate=0.0)],
                         ids=["nan", "reset", "noise", "all-down"])
def test_advance_equals_the_references(faults):
    """16 rounds of ``advance`` after ``advance_conditions`` from the
    reference's uniforms: ``active``, ``crashed``, ``corrupt``, the chain's
    ``down`` and the restarted mask exact, round by round."""
    net = _net(faults)
    rnet = ref_net(net)
    tree = {"p": torch.zeros((N, 3))}
    sched = netsim.NetSchedule(net, N, JaxDraws(0),
                               noise=resil.noise_spec(net, tree))
    chan, want_chan = sched.init_channel("cpu"), ref_netsim.init_channel(
        rnet, N)
    fstate = resil.init_state(net, N, tree)
    want_f = ref_resil.init_state(rnet, N, {"p": jnp.zeros((N, 3))})
    crashed = 0
    for rnd in range(16):
        draws = sched.round(rnd)
        conds, chan = netsim.advance_conditions(net, draws, chan)
        conds, fstate, restarted = resil.advance(net, N, conds, fstate,
                                                 draws)
        want, want_chan = ref_netsim.advance_conditions(rnet, N, rnd,
                                                        want_chan)
        want, want_f, want_r = ref_resil.advance(rnet, N, rnd, want,
                                                 want_f)
        for name in ("active", "crashed", "corrupt"):
            got_m, want_m = getattr(conds, name), getattr(want, name)
            assert (got_m is None) == (want_m is None), name
            if got_m is not None:
                np.testing.assert_array_equal(_np(got_m), want_m, name)
        np.testing.assert_array_equal(_np(fstate.down), want_f.down)
        assert (restarted is None) == (want_r is None)
        if restarted is not None:
            np.testing.assert_array_equal(_np(restarted), want_r)
        crashed += int(conds.crashed.sum())
        if faults.corrupt_mode == "noise" and faults.corrupt_rate > 0:
            assert len(conds.fault_noise) == 1
    assert crashed > 0


def test_reset_nodes_equals_the_references():
    """A FACADE state (the round counter a host int, ``cluster_id``
    int64) against the reference's dict of the same arrays: restarted
    nodes take their round-0 rows, every other row, the round and
    unsigned leaves stay."""
    n, rng = 4, np.random.default_rng(1)
    arrays = [{"cores": {"w": rng.normal(size=(n, 3, 2)).astype(np.float32)},
               "heads": {"fc": rng.normal(size=(n, 2, 5)).astype(
                   np.float32)},
               "cluster_id": rng.integers(0, 2, n).astype(np.int32),
               "key": rng.integers(0, 9, n).astype(np.uint8)}
              for _ in range(2)]
    restarted = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
    want = ref_resil.reset_nodes(n, jnp.asarray(restarted),
                                 jax.tree.map(jnp.asarray, arrays[0]),
                                 jax.tree.map(jnp.asarray, arrays[1]))

    def port(a, rnd):
        return FacadeState(
            cores=tree_map(torch.from_numpy, a["cores"]),
            heads=tree_map(torch.from_numpy, a["heads"]),
            cluster_id=torch.from_numpy(a["cluster_id"]).long(),
            round=rnd), torch.from_numpy(a["key"])

    (init, init_key), (live, live_key) = port(arrays[0], 0), port(
        arrays[1], 7)
    got = resil.reset_nodes(n, torch.from_numpy(restarted), init, live)
    assert got.round == 7
    np.testing.assert_array_equal(_np(got.cores["w"]), want["cores"]["w"])
    np.testing.assert_array_equal(_np(got.heads["fc"]), want["heads"]["fc"])
    np.testing.assert_array_equal(_np(got.cluster_id), want["cluster_id"])
    assert got.cluster_id.dtype == torch.long
    # unsigned leaves pass through (the reference's PRNG keys)
    key = resil.reset_nodes(n, torch.from_numpy(restarted), init_key,
                            live_key)
    assert torch.equal(key, live_key)
    np.testing.assert_array_equal(want["key"], arrays[1]["key"])


# ------------------------------------------------------ corruption ------
@pytest.fixture(scope="module")
def facade_tree():
    """A smoke-LeNet FACADE payload of 6 nodes (conv cores, a [n, k] head
    bank, cluster ids) on both sides: the reference's (HWIO) and the
    port's (OIHW)."""
    n, k = 6, 2
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    st = ref_init_facade(ref_bindings.make_binding(rcfg),
                         jax.random.PRNGKey(3), n, k, head_jitter=0.05)
    ref_tree = {"cores": st.cores, "heads": st.heads,
                "cluster_id": jnp.asarray([0, 1, 1, 0, 1, 0], jnp.int32)}
    tree = {"cores": params_from_jax(jax.tree.map(np.asarray, st.cores),
                                     lead=1),
            "heads": params_from_jax(jax.tree.map(np.asarray, st.heads),
                                     lead=2),
            "cluster_id": torch.tensor([0, 1, 1, 0, 1, 0])}
    return ref_tree, tree


def test_payload_leaves_number_as_jax_flattens(facade_tree):
    ref_tree, tree = facade_tree
    paths = [p for p, _ in resil.payload_leaves(tree)]
    want = [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    assert paths == want
    assert paths[0] == ("cluster_id",)
    spec = resil.noise_spec(_net(NOISE_FAULTS), tree,
                            {"cores": 1, "heads": 2})
    ref_leaves = jax.tree.leaves(ref_tree)
    assert [i for i, _, _ in spec] == list(range(1, len(ref_leaves)))
    for i, shape, axes in spec:         # drawn in the reference's layout
        assert shape == ref_leaves[i].shape
        assert (axes is not None) == (len(shape) == 5)
    assert resil.noise_spec(_net(NAN_FAULTS), tree) is None


@pytest.mark.parametrize("mode", ["noise", "scale", "nan"])
def test_corrupt_view_equals_the_references(facade_tree, mode):
    """Round 2's corrupted FACADE payload under ``edge-v2``: the port's
    (the noise from ``JaxDraws.net_normal`` through ``NetSchedule``) moved
    back to the reference's layout equals the reference's within 1e-6;
    the cluster ids and the uncorrupted nodes' leaves are untouched."""
    ref_tree, tree = facade_tree
    n, rnd = 6, 2
    fc = FaultConfig(corrupt_rate=0.5, corrupt_mode=mode)
    net = _net(fc)
    rnet = ref_net(net)
    sched = netsim.NetSchedule(net, n, JaxDraws(0), noise=resil.noise_spec(
        net, tree, {"cores": 1, "heads": 2}))
    draws = sched.round(rnd)
    conds, _ = netsim.advance_conditions(net, draws,
                                         sched.init_channel("cpu"))
    conds, _, _ = resil.advance(net, n, conds, None, draws)
    want_c, _ = ref_netsim.advance_conditions(
        rnet, n, rnd, ref_netsim.init_channel(rnet, n))
    want_c, _, _ = ref_resil.advance(rnet, n, rnd, want_c, None)
    np.testing.assert_array_equal(_np(conds.corrupt), want_c.corrupt)
    assert 0 < float(conds.corrupt.sum()) < n
    got = resil.corrupt_view(fc, conds, tree)
    want = ref_resil.corrupt_view(rnet.faults, want_c, ref_tree)
    np.testing.assert_array_equal(_np(got["cluster_id"]),
                                  want["cluster_id"])
    for key, lead in (("cores", 1), ("heads", 2)):
        back = params_to_jax(got[key], lead=lead)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want[key]),
                        strict=True):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    clean = _np(conds.corrupt) == 0
    for a, b in zip(tree_leaves(got["cores"]), tree_leaves(tree["cores"])):
        assert torch.equal(a[clean], b[clean])


def test_node_finite_and_norm_equal_the_references():
    rng = np.random.default_rng(4)
    arrays = {"a": rng.normal(size=(5, 3, 2)).astype(np.float32),
              "b": {"c": rng.normal(size=(5, 7)).astype(np.float32)},
              "id": np.arange(5, dtype=np.int32)}
    arrays["a"][1, 0, 1] = np.nan
    arrays["b"]["c"][3, 2] = np.inf
    tree = tree_map(torch.from_numpy, arrays)
    ref_tree = jax.tree.map(jnp.asarray, arrays)
    np.testing.assert_array_equal(_np(resil.node_finite(tree)),
                                  ref_resil.node_finite(ref_tree))
    np.testing.assert_allclose(_np(resil.node_norm(tree)),
                               ref_resil.node_norm(ref_tree), rtol=1e-6)
    fin = np.asarray(ref_resil.node_finite(ref_tree)) > 0
    assert fin.tolist() == [True, False, True, False, True]
    with pytest.raises(ValueError, match="float leaf"):
        resil.node_finite({"id": torch.arange(3)})


# ------------------------------------------------------ the guard -------
def _ring(n):
    return (topology.mixing_matrix(topology.ring(n, 2)),
            ref_topology.mixing_matrix(ref_topology.ring(n, 2)))


@pytest.mark.parametrize("case", ["nan", "blown"])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "visible"])
def test_gossip_mix_guard_equals_the_references(case, stale):
    """A NaN sender quarantined (receivers stay finite) and a 1e6-norm
    sender clipped (no receiver dragged far), with the visible tree given
    or the node's own: within 1e-6 of the reference; unguarded, the
    poison spreads."""
    n, rng = 5, np.random.default_rng(7)
    base = rng.normal(size=(n, 3)).astype(np.float32)
    bad = base.copy()
    if case == "nan":
        bad[1] = np.nan
    else:
        bad[2] *= 1e6
    w, rw = _ring(n)
    guard = resil.guard_of(FaultConfig(corrupt_rate=0.5, clip=3.0))
    rguard = ref_resil.guard_of(ref_resil.FaultConfig(corrupt_rate=0.5))
    if stale:
        tree, vis = {"p": torch.from_numpy(base)}, {
            "p": torch.from_numpy(bad)}
        want = ref_bindings.gossip_mix(rw, {"p": jnp.asarray(base)},
                                       {"p": jnp.asarray(bad)}, rguard)
        got = gossip_mix(w, tree, vis, guard=guard)
        plain = gossip_mix(w, tree, vis)
    else:
        tree = {"p": torch.from_numpy(bad)}
        want = ref_bindings.gossip_mix(rw, {"p": jnp.asarray(bad)},
                                       guard=rguard)
        got = gossip_mix(w, tree, guard=guard)
        plain = gossip_mix(w, tree)
    np.testing.assert_allclose(_np(got["p"]), want["p"], rtol=1e-6,
                               atol=1e-6)
    if case == "nan":
        # a poisoned node keeps only its own (here NaN) state; every other
        # receiver stays finite
        keep = np.arange(n) != (1 if not stale else -1)
        assert np.isfinite(_np(got["p"])[keep]).all()
        assert not np.isfinite(_np(plain["p"])).all()
    else:
        assert float(got["p"][np.arange(n) != 2].abs().max()) < 1e3
        assert float(plain["p"].abs().max()) > 1e4


def test_guard_off_is_the_plain_mix_bit_for_bit():
    n, rng = 6, np.random.default_rng(2)
    tree = {"p": torch.from_numpy(rng.normal(size=(n, 4)).astype(
        np.float32))}
    w, _ = _ring(n)
    assert torch.equal(gossip_mix(w, tree, guard=None)["p"],
                       gossip_mix(w, tree)["p"])


def test_aggregate_heads_guard_equals_the_references():
    """Eq. 4 under the head-bank guard: a NaN-published head quarantined
    (out of the sum and the count), a blown-up one clipped against the
    receiver's per-slot RMS norm; within 1e-6 of the reference, and the
    guard off is the plain aggregation bit for bit."""
    n, k, rng = 6, 2, np.random.default_rng(9)
    adj = np.triu((rng.random((n, n)) < 0.6).astype(np.float32), 1)
    adj = adj + adj.T
    cid = np.asarray([0, 1, 1, 0, 1, 0], np.int32)
    heads = {"fc": {"w": (0.1 * rng.normal(size=(n, k, 4, 3))).astype(
        np.float32), "b": np.zeros((n, k, 3), np.float32)}}
    sent = jax.tree.map(np.copy, heads)
    sent["fc"]["w"][1] = np.nan
    sent["fc"]["w"][4] *= 1e5
    guard = resil.guard_of(FaultConfig(corrupt_rate=0.5))
    rguard = ref_resil.guard_of(ref_resil.FaultConfig(corrupt_rate=0.5))
    port = (torch.from_numpy(adj), torch.from_numpy(cid).long(),
            tree_map(torch.from_numpy, heads))
    got = facade._aggregate_heads(*port, k,
                                  sent_heads=tree_map(torch.from_numpy,
                                                      sent), guard=guard)
    want = ref_facade._aggregate_heads(
        jnp.asarray(adj), jnp.asarray(cid), jax.tree.map(jnp.asarray, heads),
        k, sent_heads=jax.tree.map(jnp.asarray, sent), guard=rguard)
    for a, b in zip(tree_leaves(got), (want["fc"]["w"], want["fc"]["b"])):
        np.testing.assert_allclose(_np(a), b, rtol=1e-6, atol=1e-6)
        assert np.isfinite(_np(a)).all()
    plain = facade._aggregate_heads(*port, k)
    unguarded = facade._aggregate_heads(*port, k, guard=None)
    for a, b in zip(tree_leaves(plain), tree_leaves(unguarded)):
        assert torch.equal(a, b)


def test_dac_scores_a_non_finite_peer_as_dissimilar():
    """A DAC round whose node 1 ships NaNs: under the guard every score
    of node 1's model is 1 / 1e9 and the similarity table stays finite;
    unguarded the NaN enters the table."""
    cfg = facade_paper.lenet(smoke=True).replace(n_classes=4)
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=8,
                               seed=3)
    ds = synthetic.make_clustered_data(spec, (3, 2), ("rot0", "rot180"))
    n, binding = ds.n_nodes, make_binding(cfg)
    train_x, train_y = pipeline.place(ds, "cpu")
    corrupt = torch.tensor([0.0, 1.0, 0.0, 0.0, 0.0])
    conds = netsim.RoundConditions(
        edge_mask=torch.ones((n, n)), active=torch.ones(n),
        straggler=torch.zeros(n), corrupt=corrupt)
    sims = {}
    for robust in (True, False):
        fc = FaultConfig(corrupt_rate=0.5, corrupt_mode="nan",
                         robust=robust)
        program = runner.algo_program("dac", binding, n, 2, degree=2,
                                      lr=0.05, faults=fc)
        draws = runner.TorchDraws(0)
        state = program.setup(draws, torch.device("cpu")).state
        batches = pipeline.sample_round_batches(
            draws.batch_indices(n, 2, 4, train_x.shape[1]), train_x,
            train_y)
        new, info = program.round_fn(state, batches, draws.gumbel(n),
                                     net=conds)
        sims[robust] = (new.extra["sim"], info["quarantined"])
    sim, quarantined = sims[True]
    assert torch.isfinite(sim).all() and float(quarantined) == 1.0
    peers = sim[:, 1][torch.arange(n) != 1]
    assert (peers[peers != 0] == np.float32(1.0 / 1e9)).all()
    assert (peers != 0).any()
    assert not torch.isfinite(sims[False][0]).all()
    assert float(sims[False][1]) == 0.0


def test_argmin_picks_the_first_nan_as_jnp_argmin():
    """FACADE's cluster choice on losses with NaN (an unguarded faulty
    round): ``torch.argmin`` and ``jnp.argmin`` both pick a row's first
    NaN, and the least loss of a row without one."""
    nan, inf = np.nan, np.inf
    rows = np.asarray([[1.0, nan, 0.5], [nan, nan, 0.1], [2.0, 0.3, nan],
                       [inf, 0.2, 3.0], [0.4, inf, nan], [0.7, 0.7, 0.1]],
                      np.float32)
    got = torch.argmin(torch.from_numpy(rows), dim=1).tolist()
    assert got == np.asarray(jnp.argmin(jnp.asarray(rows), axis=1)).tolist()
    assert got == [1, 0, 2, 1, 2, 2]


# ------------------------------------------------------ cache key -------
_PERTURB = {
    "crash_rate": lambda v: (v + 0.1) % 1.0,
    "restart_rate": lambda v: (v + 0.25) % 1.0,
    "restart_mode": lambda v: ("reset" if v == "rejoin-stale"
                               else "rejoin-stale"),
    "corrupt_rate": lambda v: (v + 0.1) % 1.0,
    "corrupt_mode": lambda v: "scale" if v == "noise" else "noise",
    "corrupt_scale": lambda v: v + 1.0,
    "robust": lambda v: not v,
    "clip": lambda v: v + 0.5,
}


def test_every_fault_field_forks_the_engine_spec():
    assert set(_PERTURB) == {f.name for f in dataclasses.fields(FaultConfig)}
    cfg = facade_paper.lenet(smoke=True).replace(n_classes=4)

    def spec(net):
        return EngineSpec(algo="facade", cfg=cfg, n=4, k=2, degree=2,
                          local_steps=2, batch_size=4, lr=0.05,
                          device=torch.device("cpu"), net=net)

    base = spec(_net(FaultConfig(), "edge-churn"))
    assert base != spec(netsim.NetworkConfig.preset("edge-churn"))
    assert base == spec(_net(FaultConfig(), "edge-churn"))
    assert hash(base) == hash(spec(_net(FaultConfig(), "edge-churn")))
    for name, fn in _PERTURB.items():
        mutated = spec(_net(dataclasses.replace(
            FaultConfig(), **{name: fn(getattr(FaultConfig(), name))}),
            "edge-churn"))
        assert mutated != base, name
        table = {base: "b", mutated: "m"}
        assert table[base] == "b" and table[mutated] == "m"
