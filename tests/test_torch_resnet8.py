"""ResNet8 in the port against the reference on the same numpy inputs, fp32,
parameters through ``interop``: the core's features and the logits, the
``loss_fn`` gradients, the basic block's shortcuts and "SAME" padding,
the node-batched pass, each head's step-2c loss through the binding's
operands, and ``run_experiment`` for all five algorithms against the
reference's per-round loop (``engine=False``) from its own draws
(``torch_caps.JaxDraws``).

Tolerances: activations, logits and step-2c losses 1e-5 relative and
absolute (the same fp32 values, convolutions and reductions summed in
other orders); gradients, one more such pass, 2e-5 of the leaf's largest
entry; parameters after a round 1e-4 of each leaf's scale (H forward
and backward passes compound the ulps); accuracies, fair
accuracy, DP and EO 0.1 (the reference's precedent across layouts,
``tests/test_mesh.py``); bytes per round and the FACADE cluster history
exact (the FACADE run decorrelates its heads, ``head_jitter``, so no
selection is a near-tie).

Parameters are held after one round from the same state, not after a
run: ReLU makes a gradient step discontinuous, and where a step lies on
such a kink two fp32 evaluations of it part by more than 1e-4 of the
leaf's scale, the reference's own jitted and eager steps included
(``test_a_gradient_kink_parts_fp32_steps``: node 7's first step of round
4 of the FACADE run below); from there the trajectories drift apart."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import facade_paper as ref_configs
from repro.core import facade as ref_facade
from repro.core import bindings as ref_bindings
from repro.core import runner as ref_runner
from repro.core import split as ref_split
from repro.core import topology as ref_topology
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_facade_state as ref_init_facade
from repro.data import pipeline as ref_pipeline
from repro.models import cnn as ref_cnn
from repro_torch.configs import facade_paper
from repro_torch.core import facade, runner
from repro_torch.core.bindings import local_sgd, make_binding
from repro_torch.core.state import FacadeState
from repro_torch.data import pipeline, synthetic
from repro_torch.interop import params_from_jax, params_to_jax
from repro_torch.kernels.head_select import head_losses, head_losses_ref
from repro_torch.models import cnn
from repro_torch.tree import tree_leaves, tree_map
from torch_caps import JaxDraws, perms_from_key

torch.set_num_threads(1)
TOL = 1e-5
ACC_TOL = 0.1
RUN = dict(rounds=4, k=2, degree=2, local_steps=3, batch_size=8, lr=0.05,
           eval_every=2, seed=0)


def _inputs(cfg, b, seed, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (b, cfg.image_size, cfg.image_size,
                                cfg.channels))
    y = rng.integers(0, cfg.n_classes, size=lead + (b,))
    return x.astype(np.float32), y.astype(np.int32)


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        ref_cnn.init_params(cfg, jax.random.PRNGKey(seed)))


def _close(got, want, rel):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-3))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_features_and_logits(smoke):
    rcfg, cfg = ref_configs.resnet8(smoke), facade_paper.resnet8(smoke)
    params = _ref_params(rcfg)
    x, _ = _inputs(cfg, 2, 2)
    want_f = ref_cnn.resnet8_features(rcfg, params, jnp.asarray(x))
    want = ref_cnn.forward(rcfg, params, jnp.asarray(x))
    p = params_from_jax(params)
    got_f = cnn.resnet8_features(cfg, p, torch.from_numpy(x))
    got = cnn.forward(cfg, p, torch.from_numpy(x))
    assert got_f.shape == want_f.shape == (2, cfg.image_size,
                                           cfg.image_size, cfg.width // 2)
    assert got.shape == (2, cfg.n_classes)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    head = {k: p[k] for k in cnn.RESNET8_HEAD_KEYS}
    np.testing.assert_allclose(cnn.resnet8_head(cfg, head, got_f).numpy(),
                               np.asarray(want), rtol=TOL, atol=TOL)


def test_parameter_counts_and_port_init_shapes():
    """Full width: 5,136 core and 74,729 head parameters, as the
    reference's init; the port's own init has the reference's tree."""
    rcfg, cfg = ref_configs.resnet8(), facade_paper.resnet8()
    ref = _ref_params(rcfg)
    port = params_to_jax(cnn.init_params(cfg,
                                         torch.Generator().manual_seed(0)))
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    def count(keys):
        return sum(np.size(l) for k in keys for l in jax.tree.leaves(ref[k]))

    assert cnn.head_keys(cfg) == ("block2", "block3", "fc")
    assert count(("stem", "block1")) == 5136
    assert count(cnn.RESNET8_HEAD_KEYS) == 74729


@pytest.mark.parametrize("size,proj", [(8, True), (8, False), (7, True),
                                       (7, False)],
                         ids=["even-proj", "even-subsample", "odd-proj",
                              "odd-subsample"])
def test_stride_two_block_pads_as_same(size, proj):
    """``_block`` at stride 2: "SAME" pads (0, 1) on an even size and
    (1, 1) on an odd one, and without ``proj`` the shortcut is the input
    subsampled (``x[:, ::2, ::2]``), a path ResNet8 itself never takes."""
    rcfg, cfg = ref_configs.resnet8(True), facade_paper.resnet8(True)
    cin, cout = (4, 8) if proj else (8, 8)
    key = jax.random.PRNGKey(size)
    p = jax.tree.map(np.asarray,
                     ref_cnn._init_block(key, cin, cout, jnp.float32))
    p["gn1"]["b"] = np.full((cout,), 0.1, np.float32)
    x = np.random.default_rng(size).normal(
        size=(2, size, size, cin)).astype(np.float32)
    want = ref_cnn._block(rcfg, p, jnp.asarray(x), stride=2)
    h = cnn._to_nchw(torch.from_numpy(x)[None])
    got = cnn._to_nhwc(cnn._block(cfg, cnn._one(params_from_jax(p)), h, 1,
                                  stride=2), 1)[0]
    assert ("proj" in p) == proj
    assert got.shape == want.shape == (2, -(-size // 2), -(-size // 2), cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_loss_fn_value_and_gradients():
    rcfg, cfg = ref_configs.resnet8(True), facade_paper.resnet8(True)
    params = _ref_params(rcfg, seed=3)
    x, y = _inputs(cfg, 8, 4)
    (want_l, want_aux), want_g = jax.value_and_grad(
        lambda p: ref_cnn.loss_fn(rcfg, p, {"x": jnp.asarray(x), "y": y}),
        has_aux=True)(params)
    p = tree_map(lambda t: t.requires_grad_(), params_from_jax(params))
    loss, aux = cnn.loss_fn(cfg, p, {"x": torch.from_numpy(x),
                                     "y": torch.from_numpy(y).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_l), rtol=TOL)
    assert aux["acc"].item() == float(want_aux["acc"])
    _close(params_to_jax(tree_map(lambda t: t.grad, p)), want_g, 2e-5)


def test_node_batched_pass_is_each_nodes_own():
    """The binding's node-batched forward (grouped convs with groups = n)
    equals each node's own forward, and its loss is the sum of the nodes'
    own losses."""
    cfg = facade_paper.resnet8(smoke=True)
    binding = make_binding(cfg)
    nodes = [cnn.init_params(cfg, torch.Generator().manual_seed(s))
             for s in range(3)]
    for i, node in enumerate(nodes):    # GroupNorm gains away from 1
        node["block2"]["gn1"]["g"] = node["block2"]["gn1"]["g"] + 0.1 * i
    stacked = tree_map(lambda *l: torch.stack(l), *nodes)
    x, y = _inputs(cfg, 4, 5, lead=(3,))
    x, y = torch.from_numpy(x), torch.from_numpy(y).long()
    got = binding.forward(stacked, x)
    for i, node in enumerate(nodes):
        np.testing.assert_allclose(got[i].numpy(),
                                   cnn.forward(cfg, node, x[i]).numpy(),
                                   rtol=TOL, atol=TOL)
    want = sum(cnn.loss_fn(cfg, node, {"x": x[i], "y": y[i]})[0].item()
               for i, node in enumerate(nodes))
    np.testing.assert_allclose(binding.loss(stacked, {"x": x, "y": y}).item(),
                               want, rtol=1e-6)


def test_step_2c_losses_through_the_binding_operands():
    """Each (node, head)'s loss from the operands ``select_operands`` builds
    (block2 and block3 per stream, ``fc`` with its bias folded in) through
    the kernel's plain version and through the ``head_losses`` wrapper
    (CPU tensors) equals the reference's ``jax.vmap(head_loss)`` on the
    node's cached core features."""
    rcfg, cfg = ref_configs.resnet8(True), facade_paper.resnet8(True)
    rb, pb = ref_make_binding(rcfg), make_binding(cfg)
    n, k, b = 2, 3, 6
    states = [ref_init_facade(rb, jax.random.PRNGKey(i), 1, k,
                              head_jitter=0.1) for i in range(n)]
    x, y = _inputs(cfg, b, 7, lead=(n,))
    want = []
    for i, st in enumerate(states):
        core = jax.tree.map(lambda l: l[0], st.cores)
        batch = {"x": jnp.asarray(x[i]), "y": jnp.asarray(y[i])}
        feats = rb.features(core, batch)
        want.append(jax.vmap(lambda h: rb.head_loss(h, feats, batch))(
            jax.tree.map(lambda l: l[0], st.heads)))
    want = np.stack([np.asarray(w) for w in want])
    cores = tree_map(lambda *l: torch.cat(l), *[
        params_from_jax(jax.tree.map(np.asarray, st.cores), lead=1)
        for st in states])
    heads = tree_map(lambda *l: torch.cat(l), *[
        params_from_jax(jax.tree.map(np.asarray, st.heads), lead=2)
        for st in states])
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    feats = pb.features(cores, batch)
    assert feats.shape == (n, b, cfg.image_size, cfg.image_size,
                           cfg.width // 2)
    f, w, labels = pb.select_operands(feats, heads, batch)
    d = 2 * cfg.width + 1                 # block3's width and the ones column
    assert f.shape == (n * k, b, d) and w.shape == (n * k, 1, d,
                                                    cfg.n_classes)
    assert labels.shape == (n * k, b) and labels.dtype == torch.int32
    assert torch.equal(f[..., -1], torch.ones(n * k, b))
    for fn in (head_losses_ref, head_losses):
        got = fn(f, w, labels).reshape(n, k)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def ds():
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8, test_per_class=16,
                               seed=3)
    return synthetic.make_clustered_data(spec, (6, 2), ("rot0", "rot180"))


@pytest.mark.parametrize("algo,extra", [
    ("facade", {"head_jitter": 0.05}),
    ("el", {}),
    ("dpsgd", {}),
    ("deprl", {}),
    ("dac", {}),
])
def test_run_experiment_matches_the_reference(ds, algo, extra):
    kw = dict(RUN, **extra)
    rcfg = ref_configs.resnet8(smoke=True).replace(n_classes=4)
    cfg = facade_paper.resnet8(smoke=True).replace(n_classes=4)
    want = ref_runner.run_experiment(algo, rcfg, ds, engine=False, **kw)
    got = runner.run_experiment(algo, cfg, ds, device="cpu",
                                draws=JaxDraws(kw["seed"]), **kw)
    assert got.comm.rounds == want.comm.rounds
    assert got.comm.bytes == want.comm.bytes                 # exact
    assert len(got.cluster_history) == len(want.cluster_history) == (
        kw["rounds"] if algo == "facade" else 0)
    for (r1, c1), (r2, c2) in zip(got.cluster_history,
                                  want.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, np.asarray(c2))
    for (r1, a), (r2, b) in zip(got.acc_per_cluster, want.acc_per_cluster):
        assert r1 == r2
        np.testing.assert_allclose(a, b, atol=ACC_TOL)
    np.testing.assert_allclose([v for _, v in got.fair_acc],
                               [v for _, v in want.fair_acc], atol=ACC_TOL)
    assert abs(got.dp - want.dp) <= ACC_TOL
    assert abs(got.eo - want.eo) <= ACC_TOL
    assert all(bool(torch.isfinite(l).all()) for l in tree_leaves(got.models))


def test_stacked_heads_cross_interop_exactly():
    """A node-and-cluster-stacked ResNet8 head bank (``lead=2``), 1×1
    ``proj`` kernels included, round-trips through ``interop`` bit for
    bit, and each conv kernel reaches the port as OIHW."""
    st = ref_init_facade(ref_make_binding(ref_configs.resnet8(True)),
                         jax.random.PRNGKey(4), 3, 2, head_jitter=0.1)
    heads = jax.tree.map(np.asarray, st.heads)
    port = params_from_jax(heads, lead=2)
    proj = heads["block2"]["proj"]                  # [n, k, 1, 1, I, O]
    assert port["block2"]["proj"].shape == proj.shape[:2] + (
        proj.shape[5], proj.shape[4], 1, 1)
    np.testing.assert_array_equal(port["block3"]["conv1"][1, 0, 5, 3, 2, 1],
                                  heads["block3"]["conv1"][1, 0, 2, 1, 3, 5])
    back = params_to_jax(port, lead=2)
    assert jax.tree.structure(back) == jax.tree.structure(heads)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(heads)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_facade_round_matches_the_reference(ds):
    """One FACADE round (jit) of the reference and of the port from the
    same state, batches and permutations: selection losses 1e-5, cluster
    ids exact, bytes exact, parameters 1e-4 of each leaf's scale."""
    rcfg = ref_configs.resnet8(smoke=True).replace(n_classes=4)
    cfg = facade_paper.resnet8(smoke=True).replace(n_classes=4)
    rb, pb = ref_make_binding(rcfg), make_binding(cfg)
    n, k, deg, h, b = ds.n_nodes, 2, 3, 2, 8
    st = ref_init_facade(rb, jax.random.PRNGKey(1), n, k, head_jitter=0.05)
    key = jax.random.PRNGKey(7)
    want, info = jax.jit(functools.partial(
        ref_facade.facade_round,
        ref_facade.FacadeConfig(n_nodes=n, k=k, degree=deg, local_steps=h,
                                lr=0.05), rb))(
        st, ref_pipeline.sample_round_batches(key, ds.train_x, ds.train_y,
                                              h, b))
    idx = jax.random.randint(key, (n, h, b), 0, ds.train_x.shape[1])
    train_x, train_y = pipeline.place(ds, "cpu")
    got, pinfo = facade.facade_round(
        facade.FacadeConfig(n_nodes=n, k=k, degree=deg, lr=0.05), pb,
        FacadeState(cores=params_from_jax(jax.tree.map(np.asarray, st.cores),
                                          lead=1),
                    heads=params_from_jax(jax.tree.map(np.asarray, st.heads),
                                          lead=2),
                    cluster_id=torch.zeros(n, dtype=torch.long), round=0),
        pipeline.sample_round_batches(torch.from_numpy(np.array(idx)),
                                      train_x, train_y),
        perms_from_key(jax.random.split(st.rng)[1], n, deg))
    np.testing.assert_allclose(pinfo["selection_losses"].numpy(),
                               np.asarray(info["selection_losses"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.cluster_id.numpy(),
                                  np.asarray(want.cluster_id))
    assert pinfo["round_bytes"] == float(info["round_bytes"])
    _close(params_to_jax(got.cores, lead=1), want.cores, 1e-4)
    _close(params_to_jax(got.heads, lead=2), want.heads, 1e-4)


def test_a_gradient_kink_parts_fp32_steps(ds):
    """The reference's FACADE run of ``RUN`` (head jitter 0.05), continued
    by its per-round loop to the state before round 4: node 7's first
    local step, from the round's aggregated parameters, differs between
    the reference's jitted step (``vmap`` of ``local_sgd``, as its round
    runs it) and its eager ``jax.grad`` step by more than 1e-4 of a leaf's
    scale, while every other node's two steps agree within 1e-5; the
    port's step matches the reference's eager one within 1e-5 on every
    node. So no fp32 implementation can hold parameters to 1e-4 across
    this round."""
    rcfg = ref_configs.resnet8(smoke=True).replace(n_classes=4)
    cfg = facade_paper.resnet8(smoke=True).replace(n_classes=4)
    rb, pb = ref_make_binding(rcfg), make_binding(cfg)
    n, k, deg, h, b, lr = ds.n_nodes, RUN["k"], RUN["degree"], \
        RUN["local_steps"], RUN["batch_size"], RUN["lr"]
    k_init, k_data = jax.random.split(jax.random.PRNGKey(RUN["seed"]))
    setup = ref_runner.algo_setup("facade", rb, k_init, n, k, degree=deg,
                                  local_steps=h, lr=lr, head_jitter=0.05)
    step = jax.jit(setup.round_fn)
    st = setup.state
    for _ in range(4):
        k_data, k_b = jax.random.split(k_data)
        batches = ref_pipeline.sample_round_batches(
            k_b, jnp.asarray(ds.train_x), jnp.asarray(ds.train_y), h, b)
        prev, (st, info) = st, step(st, batches)
    # round 4's aggregation and selection, as the round computed them
    adj = ref_topology.random_regular(jax.random.split(prev.rng)[1], n, deg)
    cores = ref_bindings.gossip_mix(ref_topology.mixing_matrix(adj),
                                    prev.cores)
    heads = ref_facade._aggregate_heads(adj, prev.cluster_id, prev.heads, k)
    params = jax.tree.map(np.asarray, ref_split.merge_params(
        cores, jax.vmap(ref_split.select_head)(heads, st.cluster_id)))
    first = jax.tree.map(lambda l: l[:, :1], batches)
    jitted = jax.jit(jax.vmap(lambda p, bb: ref_bindings.local_sgd(
        rb, p, bb, lr)))(params, first)
    grads = jax.vmap(jax.grad(rb.loss))(
        params, jax.tree.map(lambda l: l[:, 0], batches))
    eager = jax.tree.map(lambda w, g: w - lr * g, params, grads)
    port = params_to_jax(local_sgd(
        pb, params_from_jax(params, lead=1),
        {"x": torch.from_numpy(np.array(first["x"])),
         "y": torch.from_numpy(np.array(first["y"])).long()}, lr), lead=1)

    def parted(a, c):
        """Per node: the largest difference over the leaves, each against
        its leaf's scale."""
        return np.max([np.abs(np.asarray(x) - np.asarray(y)).reshape(n, -1)
                       .max(1) / max(np.abs(np.asarray(y)).max(), 1e-3)
                       for x, y in zip(jax.tree.leaves(a),
                                       jax.tree.leaves(c))], axis=0)

    ref_spread = parted(jitted, eager)
    assert ref_spread[7] > 1e-4
    assert np.delete(ref_spread, 7).max() < 1e-5
    assert parted(port, eager).max() < 1e-5
