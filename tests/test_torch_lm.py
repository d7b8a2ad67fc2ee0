"""The port's language models against the JAX reference on the CPU:
``forward``, ``prefill`` and 8 ``decode_step``s for the dense GQA, RWKV6
and sliding-window smoke configs and for qwen3-8b (qk-norm), stablelm-12b,
minicpm3-4b (MLA, its absorbed decode), deepseek-moe-16b and grok-1-314b
(MoE, their router loss), with the reference's parameters carried across
by ``interop.lm_params_from_jax`` (mirrors
``tests/test_decode_parity.py``). Also the configs field for field, the
input-shape table and arch sets, the bf16 parameter round trip, and
RWKV's biased per-head variance.

Tolerance 1e-4 absolute and relative in fp32: both sides compute the same
arithmetic in fp32 and differ only in summation order."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import api as ref_api
from repro.models import rwkv as ref_rwkv
from repro.models import transformer as ref_tf
from repro.models.base import get_config as ref_get_config
from repro.models.base import list_archs as ref_list_archs
from repro_torch import configs as port_configs
from repro_torch.interop import lm_params_from_jax, lm_params_to_jax
from repro_torch.models import api, rwkv, transformer
from repro_torch.models.base import ModelConfig, get_config, list_archs

torch.set_num_threads(1)
TOL = 1e-4
CASES = [
    ("llama3.2-1b", {}),                       # GQA
    ("rwkv6-1.6b", {}),                        # state cache
    ("llama3.2-1b", {"sliding_window": 16}),   # SWA ring buffer
    ("qwen3-8b", {}),                          # qk-norm
    ("stablelm-12b", {}),
    ("minicpm3-4b", {}),                       # MLA, absorbed decode
    ("deepseek-moe-16b", {}),                  # MoE, shared experts
    ("grok-1-314b", {}),                       # MoE, GQA
]
NEW_ARCHS = ["qwen3-8b", "stablelm-12b", "minicpm3-4b", "deepseek-moe-16b",
             "grok-1-314b"]
IDS = [f"{a}{'-swa' if o else ''}" for a, o in CASES]


def _models(arch, overrides, seed=3):
    ref_cfg = ref_get_config(arch, smoke=True).replace(**overrides)
    cfg = get_config(arch, smoke=True).replace(**overrides)
    ref_params = ref_api.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_cfg, ref_params, cfg, lm_params_from_jax(ref_params)


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL, err_msg=msg)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"] + NEW_ARCHS
                         + ["hymba-1.5b", "llava-next-34b", "whisper-tiny"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_configs_match_the_reference_field_for_field(arch, smoke):
    """Each field of the port's config equals the reference's; each field
    the port leaves out is at the reference's default."""
    ref = ref_get_config(arch, smoke=smoke)
    got = dataclasses.asdict(get_config(arch, smoke=smoke))
    assert got == {name: getattr(ref, name) for name in got}
    left_out = [f for f in dataclasses.fields(ref) if f.name not in got]
    assert left_out
    for f in left_out:
        assert getattr(ref, f.name) == f.default, f.name
    assert get_config(arch, smoke=smoke).dt == (
        torch.float32 if smoke else torch.bfloat16)


def test_input_shapes_and_arch_sets_match_the_reference():
    """``configs/base.py``'s table and window equal the reference's, and
    so do the registry's archs and the two long-context arch sets."""
    assert port_configs.INPUT_SHAPES == {
        name: port_configs.InputShape(**dataclasses.asdict(shape))
        for name, shape in ref_configs.INPUT_SHAPES.items()}
    assert port_configs.LONG_CTX_SWA_WINDOW == \
        ref_configs.LONG_CTX_SWA_WINDOW
    assert set(port_configs.ARCH_MODULES) == set(ref_configs.ARCH_MODULES)
    assert port_configs.LONG_CTX_SWA_ARCHS == ref_configs.LONG_CTX_SWA_ARCHS
    assert port_configs.LONG_CTX_SKIP == ref_configs.LONG_CTX_SKIP


def test_unported_arch_names_the_roadmap():
    """Every reference arch is registered; a family outside
    ``transformer.PORTED`` (an encoder-decoder, which ``whisper.py`` runs,
    or an attention the family does not take) is still refused by
    ``transformer.py`` with a message naming ``ROADMAP.md``."""
    assert list_archs() == ref_list_archs()
    assert port_configs.LONG_CTX_SWA_ARCHS == ref_configs.LONG_CTX_SWA_ARCHS
    assert port_configs.LONG_CTX_SKIP == ref_configs.LONG_CTX_SKIP
    base = get_config("llama3.2-1b", smoke=True)
    for cfg in (get_config("whisper-tiny", smoke=True),
                base.replace(arch_type="hybrid", attention="mla"),
                base.replace(arch_type="cnn")):
        assert (cfg.arch_type, cfg.attention, cfg.rwkv) not in \
            transformer.PORTED
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            transformer.init_params(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ref_list_archs())
def test_port_refuses_what_its_config_cannot_express(arch):
    """A reference config that sets a field the port's ``ModelConfig``
    leaves out is refused; every other one is accepted, and ``api``
    initialises its model (the encoder-decoder's layers under
    ``decoder``)."""
    ref = ref_get_config(arch, smoke=True)
    kept = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{name: getattr(ref, name) for name in kept})
    dropped = [f.name for f in dataclasses.fields(ref)
               if f.name not in kept and getattr(ref, f.name) != f.default]
    if dropped:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            transformer.init_params(cfg, torch.Generator().manual_seed(0))
    else:
        params = api.init_params(cfg, torch.Generator().manual_seed(0))
        stack = (params["decoder"]["layers"]["ln1"]["g"] if api.is_encdec(
            cfg) else params["layers"]["norm1"])
        assert stack.shape == (cfg.n_layers, cfg.d_model)


@pytest.mark.parametrize("arch,overrides",
                         CASES + [("llama3.2-1b", {"qk_norm": True})],
                         ids=IDS + ["llama3.2-1b-qk_norm"])
def test_forward_matches_reference(arch, overrides):
    ref_cfg, ref_params, cfg, params = _models(arch, overrides)
    toks = _tokens(cfg, 2, 32)
    want, want_aux = ref_tf.forward(ref_cfg, ref_params, jnp.asarray(toks))
    got, aux = transformer.forward(cfg, params, torch.from_numpy(toks))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want)
    if cfg.is_moe:     # the layers' router losses, summed
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                                   atol=1e-5)
        assert float(aux) > 0.5
    else:
        assert float(aux) == 0.0 == float(want_aux)


@pytest.mark.parametrize("arch,overrides", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(arch, overrides):
    ref_cfg, ref_params, cfg, params = _models(arch, overrides)
    b, s_pre, s_gen = 2, 24, 8
    toks = _tokens(cfg, b, s_pre + s_gen, seed=1)
    want, ref_cache = ref_tf.prefill(ref_cfg, ref_params,
                                     jnp.asarray(toks[:, :s_pre]),
                                     cache_extra=s_gen)
    got, cache = transformer.prefill(cfg, params,
                                     torch.from_numpy(toks[:, :s_pre]),
                                     cache_extra=s_gen)
    _close(got.numpy(), want, "prefill logits")
    ref_leaves = jax.tree.leaves(ref_cache)
    leaves = jax.tree.leaves(cache)
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in ref_leaves]
    empty = transformer.init_cache(cfg, b, 40, device="cpu")
    ref_empty = ref_tf.init_cache(ref_cfg, b, 40)
    for x, y in zip(jax.tree.leaves(empty), jax.tree.leaves(ref_empty)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for t in range(s_pre, s_pre + s_gen):
        pos = np.full((b,), t, np.int32)
        want, ref_cache = ref_tf.decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(toks[:, t:t + 1]),
            jnp.asarray(pos))
        got, cache = transformer.decode_step(
            cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(pos))
        _close(got.numpy(), want, f"decode at position {t}")
    for x, y in zip(jax.tree.leaves(cache), jax.tree.leaves(ref_cache)):
        if x.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            _close(x.numpy(), y, "final cache")


def test_init_follows_the_reference_scales():
    cfg = get_config("rwkv6-1.6b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    ref = ref_api.init_params(ref_get_config("rwkv6-1.6b", smoke=True),
                              jax.random.PRNGKey(0))
    assert jax.tree.structure(ref) == jax.tree.structure(params)
    for x, y in zip(jax.tree.leaves(params), jax.tree.leaves(ref)):
        assert tuple(x.shape) == y.shape
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
        # same scale: standard deviations within 25%, constants equal
        sx, sy = float(x.float().std()), float(np.asarray(y).std())
        if sy == 0.0:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            assert abs(sx / sy - 1) < 0.25
    assert api.param_count(params) == sum(x.size
                                          for x in jax.tree.leaves(ref))
    assert api.param_bytes(params) == 4 * api.param_count(params)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-moe-16b",
                                  "grok-1-314b"])
def test_mla_and_moe_init_follow_the_reference(arch):
    """The same tree, shapes and dtypes as the reference's init, in bf16
    (the router leaf stays fp32), and the same scales in fp32."""
    for dtype in ("bfloat16", "float32"):
        cfg = get_config(arch, smoke=True).replace(dtype=dtype)
        params = api.init_params(cfg, torch.Generator().manual_seed(0))
        ref = ref_api.init_params(
            ref_get_config(arch, smoke=True).replace(dtype=dtype),
            jax.random.PRNGKey(0))
        assert jax.tree.structure(ref) == jax.tree.structure(params)
        for x, y in zip(jax.tree.leaves(params), jax.tree.leaves(ref)):
            assert tuple(x.shape) == y.shape
            assert str(x.dtype).split(".")[-1] == str(y.dtype)
            if dtype == "float32":
                sx, sy = float(x.std()), float(np.asarray(y).std())
                assert (sx == sy == 0.0) or abs(sx / sy - 1) < 0.25
        if cfg.is_moe:
            assert params["layers"]["moe"]["router"].dtype == torch.float32


def test_bf16_parameters_round_trip_bit_exactly():
    cfg = ref_get_config("llama3.2-1b", smoke=True).replace(dtype="bfloat16")
    ref = ref_api.init_params(cfg, jax.random.PRNGKey(0))
    port = lm_params_from_jax(ref)
    assert port["embed"].dtype == torch.bfloat16
    assert port["layers"]["attn"]["wq"].shape == \
        ref["layers"]["attn"]["wq"].shape          # stacked [L, ...], as is
    back = lm_params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint16), y.view(np.uint16))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-moe-16b",
                                  "hymba-1.5b", "whisper-tiny"])
def test_mla_and_moe_bf16_parameters_cross_as_they_are(arch):
    """``lm_params_from_jax`` carries the MLA, MoE, hybrid and
    encoder-decoder leaves as they are (the fp32 router and the mamba
    branch's fp32 leaves of a bf16 model, whisper's nested tree
    included), bit for bit both ways."""
    cfg = ref_get_config(arch, smoke=True).replace(dtype="bfloat16")
    ref = ref_api.init_params(cfg, jax.random.PRNGKey(1))
    port = lm_params_from_jax(ref)
    for x, y in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        assert tuple(x.shape) == y.shape
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
    if cfg.n_experts:
        assert port["layers"]["moe"]["router"].dtype == torch.float32
    if cfg.ssm_state:
        assert port["layers"]["ssm"]["a_log"].dtype == torch.float32
        assert port["layers"]["ssm"]["w_in"].dtype == torch.bfloat16
    back = lm_params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        y = np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def test_rwkv_group_norm_uses_the_biased_variance():
    """``jnp.var`` is biased; ``torch.var`` is not by default. With a
    per-head norm over 64 channels the two differ by a factor 64/63."""
    ref_cfg, ref_params, cfg, params = _models("rwkv6-1.6b", {})
    lp = jax.tree.map(lambda a: a[0], ref_params["layers"]["time_mix"])
    tp = {k: v[0] for k, v in params["layers"]["time_mix"].items()}
    x = np.random.default_rng(0).normal(size=(1, 6, cfg.d_model)).astype(
        np.float32)
    want, _, _ = ref_rwkv.time_mix(ref_cfg, lp, jnp.asarray(x))
    got, _, _ = rwkv.time_mix(cfg, tp, torch.from_numpy(x))
    _close(got.numpy(), want)
    y = torch.from_numpy(x).reshape(1, 6, -1, 64)
    assert not torch.allclose(y.var(-1), y.var(-1, unbiased=False))
