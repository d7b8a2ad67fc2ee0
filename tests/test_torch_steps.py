"""The port's step builders (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``) on the CPU, at smoke size (B 2, S 32):
both registries patched to return the smoke configs, the reference's
cases built on a 1×1 ``("data", "model")`` mesh without activation
sharding (its hooks cleared after each case), its parameters carried
across by ``interop.lm_params_from_jax``, the inputs numpy arrays from a
seed.

Tolerances: ``train_step`` after one step, the loss's metrics and
AdamW's moments 1e-5 (absolute and relative), the parameters 1e-5 where
the gradient exceeds 1e-6 in magnitude and within twice the step's size
(2 lr) elsewhere: Adam's first step is ``lr·g/(|g| + 1e-8)``, so at a
gradient near its eps the last digits of g (another summation order)
decide the step, up to lr either way on each side; grok-1's
momentum slots (bf16: the gradient rounded) within one bf16 ulp plus
1e-5; ``prefill_step`` and
``serve_step`` logits and caches 1e-4 (``tests/test_torch_lm.py``'s);
``facade_step`` states 1e-4 of each leaf's scale and cluster ids equal;
``remat`` on against off 1e-6.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.configs as ref_configs
import repro.models.base as ref_base
import repro_torch.configs  # noqa: F401  (registry)
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_facade_state as ref_init_facade
from repro.launch import steps as ref_steps
from repro.models import api as ref_api
from repro.models import hooks as ref_hooks
from repro_torch.configs import INPUT_SHAPES
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import init_facade_state
from repro_torch.interop import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch import steps
from repro_torch.models import base, transformer
from repro_torch.models.base import get_config
from repro_torch.tree import tree_map
from torch_caps import JaxDraws, ref_cfg

torch.set_num_threads(1)
B, S = 2, 32
TRAIN_TOL, LM_TOL, REMAT_TOL = 1e-5, 1e-4, 1e-6
ARCHS = ["llama3.2-1b", "rwkv6-1.6b", "whisper-tiny", "deepseek-moe-16b"]
MESH = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture
def smoke(monkeypatch):
    """Patch both registries so ``arch`` resolves to its smoke config;
    returns (reference config, port config)."""
    def patch(arch):
        rcfg = ref_base.get_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)
        monkeypatch.setitem(ref_base._REGISTRY, arch,
                            lambda smoke=False, c=rcfg: c)
        monkeypatch.setitem(base._REGISTRY, arch,
                            lambda smoke=False, c=cfg: c)
        return rcfg, cfg

    yield patch
    ref_hooks.clear()


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _trees_close(got, want, tol, msg=""):
    """Every leaf of a port tree (tensors) against the reference's."""
    got_l = jax.tree.leaves(lm_params_to_jax(got))
    want_l = jax.tree.leaves(want)
    assert len(got_l) == len(want_l), msg
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == np.shape(w), (msg, i)
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(g, np.asarray(w), f"{msg} {i}")
        else:
            _close(g, w, tol, f"{msg} leaf {i}")


def _batch(cfg, seed=1, masked=0.2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((B, S)) >= masked).astype(np.float32)}
    if cfg.encoder_layers > 0:
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)
                                     ).astype(np.float32)
    return batch


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _params(rcfg, seed=3):
    rp = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    return rp, lm_params_from_jax(rp)


def _cases(arch, shape, **kw):
    ref = ref_steps.build_case(arch, shape, MESH, act_sharding=False, **kw)
    port = steps.build_case(arch, shape, abstract=True, **kw)
    return ref, port


# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, smoke):
    """One AdamW step: the new parameters, the metrics (``ce``, ``aux``,
    ``acc``) and both moments."""
    rcfg, cfg = smoke(arch)
    ref, port = _cases(arch, "train_4k")
    rp, p = _params(rcfg)
    batch = _batch(cfg)
    ropt = ref_steps.make_optimizer(arch, rcfg)
    want_p, want_o, want_m = jax.jit(ref.step_fn)(rp, ropt.init(rp),
                                                  _to_jax(batch))
    opt = steps.make_optimizer(arch, cfg)
    got_p, got_o, got_m = port.step_fn(p, opt.init(p), _to_torch(batch))
    for name in ("ce", "aux", "acc"):
        _close(got_m[name].item(), want_m[name], TRAIN_TOL, name)
    assert got_o["count"] == int(want_o["count"]) == 1
    for slot in ("m", "v"):
        _trees_close(got_o[slot], want_o[slot], TRAIN_TOL, slot)
    lr = 3e-4
    for g, w, m in zip(jax.tree.leaves(lm_params_to_jax(got_p)),
                       jax.tree.leaves(want_p), jax.tree.leaves(want_o["m"]),
                       strict=True):
        w, grad = np.asarray(w), np.asarray(m) / 0.1     # m = (1 - b1) g
        big = np.abs(grad) > 1e-6
        _close(g[big], w[big], TRAIN_TOL, "params")
        assert np.abs(g - w).max() <= 2 * lr


def test_grok_momentum_step_with_bf16_slots_matches_the_reference(smoke):
    arch = "grok-1-314b"
    rcfg, cfg = smoke(arch)
    ref, port = _cases(arch, "train_4k")
    rp, p = _params(rcfg)
    batch = _batch(cfg)
    ropt = ref_steps.make_optimizer(arch, rcfg)
    want_p, want_o, _ = jax.jit(ref.step_fn)(rp, ropt.init(rp),
                                             _to_jax(batch))
    opt = steps.make_optimizer(arch, cfg)
    got_p, got_o, _ = port.step_fn(p, opt.init(p), _to_torch(batch))
    _trees_close(got_p, want_p, TRAIN_TOL, "params")
    got_m = jax.tree.leaves(lm_params_to_jax(got_o["m"]))
    want_m = jax.tree.leaves(want_o["m"])
    assert all(g.dtype == np.asarray(w).dtype and str(g.dtype) == "bfloat16"
               for g, w in zip(got_m, want_m, strict=True))
    for g, w in zip(got_m, want_m):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        top = np.maximum(np.abs(g), np.abs(w))
        ulp = np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
        assert (np.abs(g - w) <= ulp + TRAIN_TOL).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_the_reference(arch, smoke):
    """Last-position logits and the filled cache (whisper: the logits in
    fp32 and the encoding)."""
    rcfg, cfg = smoke(arch)
    ref, port = _cases(arch, "prefill_32k")
    rp, p = _params(rcfg)
    batch = _batch(cfg)
    want = jax.jit(ref.step_fn)(rp, _to_jax(batch))
    got = port.step_fn(p, _to_torch(batch))
    assert got[0].dtype == torch.float32
    _close(got[0], want[0], LM_TOL, "logits")
    _trees_close(got[1], want[1], LM_TOL, "cache")


def _filled_cache(cfg, cache_len, pos, seed=4):
    """A filled decode cache (``steps``' fill) as tensors and as numpy."""
    if cfg.encoder_layers > 0:
        empty = steps._whisper_cache(cfg, B, cache_len, "cpu")
    else:
        empty = transformer.init_cache(cfg, B, cache_len, "cpu")
    cache = steps._fill_cache(empty, pos, torch.Generator().manual_seed(seed))
    return cache, lm_params_to_jax(cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_the_reference(arch, smoke):
    """One decode step into a filled 64-slot cache (whisper's self cache
    and its cross keys and values) at position 40: logits and the new
    cache."""
    rcfg, cfg = smoke(arch)
    ref, port = _cases(arch, "decode_32k")
    rp, p = _params(rcfg)
    pos = 40
    cache, rcache = _filled_cache(cfg, 64, pos)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (B, 1)).astype(np.int32)
    posv = np.full((B,), pos, np.int32)
    want, want_c = jax.jit(ref.step_fn)(rp, rcache, jnp.asarray(toks),
                                        jnp.asarray(posv))
    got, got_c = port.step_fn(p, cache, torch.from_numpy(toks),
                              torch.from_numpy(posv))
    _close(got, want, LM_TOL, "logits")
    _trees_close(got_c, want_c, LM_TOL, "cache")


def test_long_500k_decodes_at_the_last_position_in_its_window(smoke):
    """llama's smoke config at ``long_500k``: the sliding-window variant
    (8,192 slots), a ring buffer filled as a prefill of 524,287 positions
    leaves it, one decode step at position 524,287 (RoPE angles there in
    fp32, the slot 524,287 % 8,192). The reference runs with jit off:
    jitted, XLA's fused cos and sin on the CPU miss by up to 1.8e-3 at
    angles of 5e5 rad (``test_rope_tables_at_position_524287``)."""
    arch = "llama3.2-1b"
    rcfg, cfg = smoke(arch)
    ref, port = _cases(arch, "long_500k")
    rp, p = _params(rcfg)
    assert steps.resolve_config(arch, "long_500k").sliding_window == 8192
    pos = INPUT_SHAPES["long_500k"].seq_len - 1
    cache_len = transformer.cache_physical_len(port.cfg, pos + 1)
    assert cache_len == 8192
    assert port.args[1]["k"].shape[2] == cache_len
    cache, rcache = _filled_cache(port.cfg, cache_len, pos)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (B, 1)).astype(np.int32)
    posv = np.full((B,), pos, np.int32)
    with jax.disable_jit():
        want, want_c = ref.step_fn(rp, rcache, jnp.asarray(toks),
                                   jnp.asarray(posv))
    got, got_c = port.step_fn(p, cache, torch.from_numpy(toks),
                              torch.from_numpy(posv))
    _close(got, want, LM_TOL, "logits")
    _trees_close(got_c, want_c, LM_TOL, "cache")
    assert int(got_c["slot_pos"][0, 0, pos % cache_len]) == pos


def test_rope_tables_at_position_524287():
    """The port's RoPE tables at positions up to 524,287 (llama's head
    dim and theta) equal the reference's eager ones and are within 1e-7
    of float64 cos and sin of the same fp32 angles; the reference's
    jitted tables there miss by more than 1e-4 (XLA's fused CPU cos and
    sin; a reference-side gap, ``ROADMAP.md`` queue 3)."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    cfg = get_config("llama3.2-1b")
    pos = np.array([[524287, 70000, 4095, 1]], np.int32)
    got = layers.rope_freqs(torch.from_numpy(pos), cfg.hd, cfg.rope_theta)
    eager = ref_layers.rope_freqs(jnp.asarray(pos), cfg.hd, cfg.rope_theta)
    jitted = jax.jit(lambda q: ref_layers.rope_freqs(q, cfg.hd,
                                                     cfg.rope_theta))(
        jnp.asarray(pos))
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, cfg.hd, 2,
                                                 dtype=torch.float32)
                                    / cfg.hd))
    ang = (torch.from_numpy(pos).float()[..., None] * inv).double().numpy()
    for g, e, j, exact in zip(got, eager, jitted, (np.cos(ang),
                                                   np.sin(ang))):
        _close(g, e, 1e-7)
        np.testing.assert_allclose(g.numpy(), exact, rtol=0, atol=1e-7)
        assert np.abs(np.asarray(j) - exact).max() > 1e-4


def test_slot_positions_are_what_prefill_leaves():
    """``steps.slot_positions`` against the ring buffer and the full cache
    that ``transformer.prefill`` fills."""
    cfg = get_config("llama3.2-1b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    for window, s in ((16, 100), (0, 24)):
        c = cfg.replace(sliding_window=window)
        toks = torch.randint(0, c.vocab_size, (1, s),
                             generator=torch.Generator().manual_seed(1))
        _, cache = transformer.prefill(c, params, toks)
        want = cache["slot_pos"][0, 0]
        assert torch.equal(steps.slot_positions(want.shape[0], s, "cpu"),
                           want)


def test_facade_step_matches_the_reference(smoke):
    """The FACADE step at n 2, k 2 (degree 1, lr 1e-3, one local step, 2
    sequences of 32 tokens a node) from the reference's initial state,
    its topology replayed by ``JaxDraws``: cores and heads 1e-4 of each
    leaf's scale, cluster ids and bytes equal."""
    arch = "llama3.2-1b"
    rcfg, cfg = smoke(arch)
    seed = 0
    ref = ref_steps.build_facade_case(arch, MESH, batch_per_node=B, seq=S,
                                      act_sharding=False)
    ref_hooks.clear()
    port = steps.build_facade_case(arch, batch_per_node=B, seq=S,
                                   abstract=True)
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    ref_state = ref_init_facade(ref_make_binding(rcfg), k_init, 2, 2)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 1, B, S + 1)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
               "mask": np.ones((2, 1, B, S), np.float32)}
    want, info = jax.jit(ref.step_fn)(ref_state, _to_jax(batches))

    draws = JaxDraws(seed)
    binding = make_binding(cfg)
    params, heads_k = draws.facade_init(binding, 2, 0.0)
    state = init_facade_state(binding, 2, 2, params=params, heads_k=heads_k,
                              device="cpu")
    got, pinfo = port.step_fn(state, _to_torch(batches), draws.perms(2, 1))
    np.testing.assert_array_equal(got.cluster_id.numpy(),
                                  np.asarray(want.cluster_id))
    assert pinfo["round_bytes"] == float(info["round_bytes"])
    for got_tree, want_tree in ((got.cores, want.cores),
                                (got.heads, want.heads)):
        for g, w in zip(jax.tree.leaves(lm_params_to_jax(got_tree)),
                        jax.tree.leaves(want_tree), strict=True):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g, w, rtol=0, atol=LM_TOL * max(np.abs(w).max(), 1e-3))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny"])
def test_remat_changes_no_value(arch, smoke):
    """``train_step`` with ``remat`` on against off, and the FACADE
    binding's loss gradients: equal within 1e-6."""
    rcfg, cfg = smoke(arch)
    _, p = _params(rcfg)
    batch = _to_torch(_batch(cfg))
    outs = []
    for remat in (True, False):
        case = steps.build_case(arch, "train_4k", remat=remat, abstract=True)
        opt = steps.make_optimizer(arch, cfg)
        outs.append(case.step_fn(p, opt.init(p), batch))
    (p1, o1, m1), (p0, o0, m0) = outs
    _close(m1["ce"].item(), m0["ce"].item(), REMAT_TOL)
    for a, b in zip(jax.tree.leaves(lm_params_to_jax(p1)),
                    jax.tree.leaves(lm_params_to_jax(p0))):
        _close(a, b, REMAT_TOL)
    for a, b in zip(jax.tree.leaves(lm_params_to_jax(o1["v"])),
                    jax.tree.leaves(lm_params_to_jax(o0["v"]))):
        _close(a, b, REMAT_TOL)
    nodes = tree_map(lambda t: t[None].expand((2,) + t.shape).clone(), p)
    nb = {k: torch.stack([v, v]) for k, v in batch.items()}
    grads = []
    for remat in (True, False):
        leaves = [t.detach().requires_grad_() for t in jax.tree.leaves(nodes)]
        tree = jax.tree.unflatten(jax.tree.structure(nodes), leaves)
        loss = make_binding(cfg, remat=remat).loss(tree, nb)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        _close(a, b, REMAT_TOL)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", sorted(ref_configs.ARCH_MODULES))
def test_resolve_config_and_is_supported_match_the_reference(arch, shape):
    assert steps.is_supported(arch, shape) == ref_steps.is_supported(arch,
                                                                      shape)
    got = ref_cfg(steps.resolve_config(arch, shape))
    want = ref_steps.resolve_config(arch, shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_abstract_cases_have_the_reference_layouts():
    """The full-size inputs of the port's abstract cases have the shapes
    and dtypes of the reference's ``ShapeDtypeStruct``s (batch, cache,
    tokens and positions; parameters by count), for the VLM's image
    positions, whisper's decoder length and frames, and a ring buffer."""
    for arch, shape in (("llava-next-34b", "train_4k"),
                        ("whisper-tiny", "prefill_32k"),
                        ("whisper-tiny", "decode_32k"),
                        ("qwen3-8b", "long_500k")):
        ref = ref_steps.build_case(arch, shape, MESH, act_sharding=False)
        ref_hooks.clear()
        port = steps.build_case(arch, shape, abstract=True)
        first = 2 if port.kind == "train" else 1
        want = jax.tree.leaves(ref.args_sds[first:])
        got = jax.tree.leaves(list(port.args[first:]))
        assert [tuple(g.shape) for g in got] == [w.shape for w in want], \
            (arch, shape)
        assert [str(g.dtype).split(".")[-1] for g in got] == \
            [str(w.dtype) for w in want], (arch, shape)
        n_ref = sum(int(np.prod(x.shape)) for x in
                    jax.tree.leaves(ref.args_sds[0]))
        assert sum(t.numel() for t in jax.tree.leaves(port.args[0])) == n_ref
