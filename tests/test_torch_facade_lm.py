"""FACADE on a language model: the port against the JAX reference on the
CPU, on the llama3.2-1b smoke config (fp32), with the reference's
parameters carried across by ``interop.lm_params_from_jax``.

Tolerances (stated per check): ``loss_fn`` values 1e-5 and gradients 1e-4
(absolute and relative: the same fp32 arithmetic in another summation
order); ``chunked_ce`` 1e-5; each head's step-2c loss through the plain
version of the head-select kernel against the reference binding's
``head_loss`` 1e-5; one ``facade_round``: selection losses 1e-5, cluster
ids exact where the two heads' losses are more than 1e-4 apart, cores and
heads within 1e-4 of each leaf's scale (as ``test_torch_round.py``); the
token data exactly.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
import repro_torch.configs  # noqa: F401  (registry)
from repro.core import facade as ref_facade
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_facade_state as ref_init_facade
from repro.data import pipeline as ref_pipeline
from repro.data import tokens as ref_tokens
from repro.models import transformer as ref_tf
from repro.models.base import get_config as ref_get_config
from repro_torch.core import facade, runner
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import init_facade_state
from repro_torch.data import pipeline, tokens
from repro_torch.interop import lm_params_from_jax, lm_params_to_jax
from repro_torch.kernels.head_select import head_losses
from repro_torch.models import attention, transformer
from repro_torch.models.base import get_config
from repro_torch.tree import tree_leaves, tree_map
from torch_caps import JaxDraws

torch.set_num_threads(1)
ARCH = "llama3.2-1b"
VALUE_TOL, GRAD_TOL = 1e-5, 1e-4


def _cfgs(arch=ARCH):
    return ref_get_config(arch, smoke=True), get_config(arch, smoke=True)


def _batch(vocab, b, s, seed, masked=0.0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) >= masked).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("untied", [False, True], ids=["tied", "untied"])
def test_loss_fn_value_and_gradients_match_the_reference(untied):
    check_loss_fn(ARCH, untied)


def check_loss_fn(arch, untied):
    """``transformer.loss_fn`` of ``arch``'s smoke config against the
    reference's on one batch: value (MoE's router loss included) and its
    ``ce``, ``aux`` and ``acc`` metrics 1e-5, every gradient 1e-4."""
    rcfg, cfg = _cfgs(arch)
    key = jax.random.PRNGKey(4)
    ref_params = (ref_make_binding(rcfg).init(key) if untied else
                  ref_tf.init_params(rcfg, key))
    assert ("lm_head" in ref_params) == untied
    batch = _batch(cfg.vocab_size, 2, 40, seed=1, masked=0.2)
    (want, want_m), want_g = jax.value_and_grad(
        lambda p: ref_tf.loss_fn(rcfg, p, {k: jnp.asarray(v) for k, v in
                                           batch.items()}),
        has_aux=True)(ref_params)

    params = tree_map(lambda t: t.requires_grad_(),
                      lm_params_from_jax(ref_params))
    got, got_m = transformer.loss_fn(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    _close(got.item(), want, VALUE_TOL)
    for name in ("ce", "aux", "acc"):
        _close(got_m[name].item(), want_m[name], VALUE_TOL, name)
    got_g = lm_params_to_jax(tree_map(lambda t: t.grad, params))
    for g, w in zip(jax.tree.leaves(got_g), jax.tree.leaves(want_g),
                    strict=True):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("s", [1024, 600, 40])
def test_chunked_ce_matches_the_reference(s):
    """S above the 512-token chunk (two chunks), not divisible by it (one
    chunk) and below it; a fifth of the positions masked out."""
    rng = np.random.default_rng(s)
    b, d, v = 2, 16, 64
    feats = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) / 4).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) >= 0.2).astype(np.float32)
    want = ref_tf.chunked_ce(jnp.asarray(feats), jnp.asarray(w),
                             jnp.asarray(labels), jnp.asarray(mask))
    got = transformer.chunked_ce(torch.from_numpy(feats),
                                 torch.from_numpy(w),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    _close(got[0].item(), want[0], VALUE_TOL)
    _close(got[1].item(), want[1], VALUE_TOL)


def test_head_losses_match_the_reference_binding_head_loss():
    """Step 2c: each head's loss on its own normed stream, through the
    LM binding's operands and the plain version of the kernel, against
    the reference binding's ``head_loss`` (n 2, k 3, a fifth masked)."""
    rcfg, cfg = _cfgs()
    rb, pb = ref_make_binding(rcfg), make_binding(cfg)
    n, k = 2, 3
    rng = np.random.default_rng(5)
    d, v = cfg.d_model, cfg.vocab_size
    feats = rng.normal(size=(n, 2, 32, d)).astype(np.float32)
    heads = {"final_norm": (1 + 0.1 * rng.normal(size=(n, k, d))).astype(
                 np.float32),
             "lm_head": (0.02 * rng.normal(size=(n, k, d, v))).astype(
                 np.float32)}
    batches = [_batch(v, 2, 32, seed=10 + i, masked=0.2) for i in range(n)]
    want = np.array([[float(rb.head_loss(
        {key: jnp.asarray(h[i, j]) for key, h in heads.items()},
        jnp.asarray(feats[i]), {key: jnp.asarray(x) for key, x in
                                batches[i].items()}))
        for j in range(k)] for i in range(n)])
    batch = {key: torch.from_numpy(np.stack([bt[key] for bt in batches]))
             for key in batches[0]}
    f, w, labels = pb.select_operands(
        torch.from_numpy(feats), tree_map(torch.from_numpy, heads), batch)
    assert f.shape == (n * k, 64, d) and w.shape == (n * k, 1, d, v)
    assert labels.dtype == torch.int32 and int((labels < 0).sum()) == \
        k * int((batch["mask"] == 0).sum())
    got = head_losses(f, w, labels).reshape(n, k).numpy()
    _close(got, want, VALUE_TOL)
    np.testing.assert_array_equal(got.argmin(1), want.argmin(1))


def test_clustered_tokens_and_lm_batch_equal_the_reference():
    spec = dict(vocab_size=97, seq_len=17, branching=3, seed=6)
    want = ref_tokens.make_clustered_tokens(ref_tokens.TokenSpec(**spec),
                                            (2, 1), seqs_per_node=5,
                                            test_seqs=4)
    got = tokens.make_clustered_tokens(tokens.TokenSpec(**spec), (2, 1),
                                       seqs_per_node=5, test_seqs=4)
    np.testing.assert_array_equal(got["train"], want["train"])
    np.testing.assert_array_equal(got["node_cluster"], want["node_cluster"])
    for g, w in zip(got["test"], want["test"], strict=True):
        np.testing.assert_array_equal(g, w)
    for key, w in ref_tokens.lm_batch(want["train"]).items():
        np.testing.assert_array_equal(tokens.lm_batch(got["train"])[key], w)


def test_token_batches_equal_the_reference():
    train = tokens.make_clustered_tokens(tokens.TokenSpec(seq_len=9),
                                         (1, 2), seqs_per_node=6)["train"]
    key = jax.random.PRNGKey(8)
    want = ref_pipeline.sample_round_token_batches(key, jnp.asarray(train),
                                                   3, 2)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (3, 3, 2), 0,
                                                       6))).long()
    got = pipeline.sample_round_token_batches(idx, torch.from_numpy(train))
    for name in ("tokens", "labels", "mask"):
        assert got[name].shape == (3, 3, 2, 8)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(
            want[name]))


def test_init_facade_state_takes_the_lm_binding():
    cfg = get_config(ARCH, smoke=True)
    st = init_facade_state(make_binding(cfg), 3, 2, head_jitter=1e-3,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    d, v = cfg.d_model, cfg.vocab_size
    assert st.heads["final_norm"].shape == (3, 2, d)
    assert st.heads["lm_head"].shape == (3, 2, d, v)
    assert "lm_head" not in st.cores and "final_norm" not in st.cores
    assert 0.015 < float(st.heads["lm_head"][0, 0].std()) < 0.025
    assert not torch.equal(st.heads["lm_head"][:, 0],
                           st.heads["lm_head"][:, 1])
    assert torch.equal(st.heads["lm_head"][0], st.heads["lm_head"][2])
    assert torch.equal(st.cores["embed"][0], st.cores["embed"][1])


def test_gqa_forward_trains_through_the_plain_sdpa():
    """Under grad the attention is the differentiable ``sdpa``; without,
    the kernel's wrapper (its plain version on the CPU). Same values."""
    cfg = get_config(ARCH, smoke=True)
    g = torch.Generator().manual_seed(2)
    p = attention.init_gqa(g, cfg)
    x = torch.randn((2, 24, cfg.d_model), generator=g)
    pos = torch.arange(24, dtype=torch.int32)[None].expand(2, 24)
    with torch.no_grad():
        want = attention.gqa_forward(cfg, p, x, pos)
    xg = x.clone().requires_grad_()
    got = attention.gqa_forward(cfg, p, xg, pos)
    got.square().sum().backward()
    torch.testing.assert_close(got.detach(), want, rtol=1e-5, atol=1e-5)
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


@pytest.mark.parametrize("warmup", [False, True], ids=["main", "warmup"])
def test_facade_round_matches_the_reference(warmup):
    check_facade_round(ARCH, warmup)


def check_facade_round(arch, warmup):
    """One round of ``arch``'s smoke config at ``tests/test_facade_lm.py``'s
    shapes (n 2, k 2, H 1, B 2, S 32, head_jitter 1e-3) from the
    reference's draws, replayed by ``JaxDraws``: initial state, batch
    indices and topology."""
    rcfg, cfg = _cfgs(arch)
    rb, pb = ref_make_binding(rcfg), make_binding(cfg)
    n, k, h, b, s, deg, lr, jitter, seed = 2, 2, 1, 2, 32, 1, 1e-2, 1e-3, 0
    train = tokens.make_clustered_tokens(
        tokens.TokenSpec(vocab_size=cfg.vocab_size, seq_len=s + 1), (1, 1),
        seqs_per_node=8)["train"]

    k_init, k_data = jax.random.split(jax.random.PRNGKey(seed))
    ref_st = ref_init_facade(rb, k_init, n, k, head_jitter=jitter)
    _, k_b = jax.random.split(k_data)
    ref_batches = ref_pipeline.sample_round_token_batches(
        k_b, jnp.asarray(train), h, b)
    fcfg = ref_facade.FacadeConfig(n_nodes=n, k=k, degree=deg,
                                   local_steps=h, lr=lr, head_jitter=jitter)
    want, info = jax.jit(functools.partial(
        ref_facade.facade_round, fcfg, rb, warmup=warmup))(ref_st,
                                                           ref_batches)

    draws = JaxDraws(seed)
    params, heads_k = draws.facade_init(pb, k, jitter)
    st = init_facade_state(pb, n, k, params=params, heads_k=heads_k,
                           device="cpu")
    batches = pipeline.sample_round_token_batches(
        draws.batch_indices(n, h, b, train.shape[1]),
        torch.from_numpy(train))
    for name in batches:
        np.testing.assert_array_equal(batches[name].numpy(),
                                      np.asarray(ref_batches[name]))
    got, pinfo = facade.facade_round(
        facade.FacadeConfig(n_nodes=n, k=k, degree=deg, lr=lr), pb, st,
        batches, draws.perms(n, deg), warmup=warmup)

    losses = np.asarray(info["selection_losses"])
    _close(pinfo["selection_losses"].numpy(), losses, VALUE_TOL)
    apart = np.abs(losses[:, 0] - losses[:, 1]) > 1e-4
    assert apart.any()
    np.testing.assert_array_equal(got.cluster_id.numpy()[apart],
                                  np.asarray(want.cluster_id)[apart])
    assert pinfo["round_bytes"] == float(info["round_bytes"])
    for got_tree, want_tree in ((got.cores, want.cores),
                                (got.heads, want.heads)):
        for g, w in zip(jax.tree.leaves(lm_params_to_jax(got_tree)),
                        jax.tree.leaves(want_tree), strict=True):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-3))


def test_lm_facade_replays_a_loop_of_facade_rounds():
    """``runner.LMFacade`` is the loop a user would write: the state from
    ``init_facade_state`` on a generator seeded with ``seed``, clustered
    token streams, ``TorchDraws(seed)`` batches and topologies, then
    ``facade_round``; the same rounds give the same state and infos
    exactly, and the caller's TF32 flags are left as they were."""
    cfg = get_config(ARCH, smoke=True)
    p = dict(clusters=(1, 1), k=2, degree=1, local_steps=2, batch=2, seq=32,
             lr=1e-2, head_jitter=1e-3, seqs_per_node=8, seed=3)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    run = runner.LMFacade(cfg, device="cpu", **p)
    infos = [run.round(), run.round(run.draw())]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags

    binding, draws = make_binding(cfg), runner.TorchDraws(p["seed"])
    st = init_facade_state(binding, 2, p["k"], device="cpu",
                           head_jitter=p["head_jitter"],
                           generator=torch.Generator().manual_seed(p["seed"]))
    train = torch.from_numpy(tokens.make_clustered_tokens(
        tokens.TokenSpec(vocab_size=cfg.vocab_size, seq_len=p["seq"] + 1,
                         seed=p["seed"]), p["clusters"],
        seqs_per_node=p["seqs_per_node"])["train"])
    fcfg = facade.FacadeConfig(n_nodes=2, k=p["k"], degree=p["degree"],
                               lr=p["lr"])
    for info in infos:
        batches = pipeline.sample_round_token_batches(
            draws.batch_indices(2, p["local_steps"], p["batch"],
                                train.shape[1]), train)
        st, want = facade.facade_round(fcfg, binding, st, batches,
                                       draws.perms(2, p["degree"]))
        assert torch.equal(info["selection_losses"],
                           want["selection_losses"])
        assert torch.equal(info["cluster_id"], want["cluster_id"])
        assert info["round_bytes"] == want["round_bytes"]
    for got, want in zip(
            tree_leaves(run.state.cores) + tree_leaves(run.state.heads),
            tree_leaves(st.cores) + tree_leaves(st.heads), strict=True):
        assert torch.equal(got, want)
