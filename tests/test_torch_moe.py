"""The port's MoE layer (``models/moe.py``) against the JAX reference's on
the CPU, with the reference's parameters carried across by
``interop.lm_params_from_jax`` (mirrors ``tests/test_moe.py``): the
capacity dispatch against the reference's ``moe_forward`` and against the
port's dense oracle, a capacity that drops tokens (the same pairs dropped,
so the same outputs zeroed), a balanced router against a collapsed one for
the aux loss, shared experts, and ``moe_capacity``.

Tolerances: outputs 1e-4 (``test_torch_lm.py``'s ``TOL``: the same fp32
arithmetic in another summation order), the aux loss 1e-5
(``test_torch_facade_lm.py``'s ``VALUE_TOL``); the port's dispatch against
its own dense oracle 1e-5; in bf16 against the reference in bf16 2e-2 (the
reference kernel tests' bf16 tolerance).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
from conftest import requires_set_mesh
import repro_torch.configs  # noqa: F401  (registry)
from repro.models import moe as ref_moe
from repro.models.base import get_config as ref_get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import moe
from repro_torch.models.base import get_config

torch.set_num_threads(1)
TOL, VALUE_TOL = 1e-4, 1e-5


def _cfgs(e=4, k=2, shared=0, dtype="float32"):
    kw = dict(n_experts=e, experts_per_token=k, n_shared_experts=shared,
              dtype=dtype)
    return (ref_get_config("deepseek-moe-16b", smoke=True).replace(**kw),
            get_config("deepseek-moe-16b", smoke=True).replace(**kw))


def _layer(rcfg, seed, shape):
    """The reference's MoE parameters and a 0.3-randn input (numpy fp32,
    the reference's and the port's copies of the same values)."""
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg)
    x = (0.3 * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)
    return p, lm_params_from_jax(p), x


def _both(rcfg, cfg, ref_p, p, x, **kw):
    want, want_aux = ref_moe.moe_forward(rcfg, ref_p,
                                         jnp.asarray(x, rcfg.dt), **kw)
    got, aux = moe.moe_forward(cfg, p, torch.from_numpy(x).to(cfg.dt), **kw)
    return (got.float().numpy(), float(aux),
            np.asarray(want, np.float32), float(want_aux))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


# (seed, b, s, e, k): the reference test's hypothesis ranges, b 1-3,
# s 16/32, e 2/4, k 1/2
DISPATCH = [(0, 1, 16, 2, 1), (1, 2, 32, 4, 2), (2, 3, 16, 4, 1),
            (3, 3, 32, 2, 2), (4, 2, 16, 4, 2)]


@pytest.mark.parametrize("seed,b,s,e,k", DISPATCH)
def test_dispatch_matches_the_reference_and_the_dense_oracle(seed, b, s, e,
                                                             k):
    """With a capacity that drops nothing, the capacity dispatch equals
    the reference's and the port's dense oracle (every expert on every
    token)."""
    rcfg, cfg = _cfgs(e=e, k=k)
    ref_p, p, x = _layer(rcfg, seed, (b, s, cfg.d_model))
    got, aux, want, want_aux = _both(rcfg, cfg, ref_p, p, x,
                                     capacity_factor=float(e * 4))
    _close(got, want, TOL)
    _close(aux, want_aux, VALUE_TOL)
    dense, dense_aux = moe.moe_forward_dense(cfg, p, torch.from_numpy(x))
    _close(got, dense.numpy(), 1e-5)
    assert float(dense_aux) == aux


def test_capacity_drops_the_reference_tokens():
    """A capacity of 32 slots an expert for 256 (token, k) pairs over 4
    experts drops about half of them: the port keeps and drops the same
    pairs (ranks in flattened (token, k) order), so the same tokens come
    out zero and the rest agree; more capacity carries more energy."""
    rcfg, cfg = _cfgs(e=4, k=2)
    assert moe.moe_capacity(cfg, 128, 0.5) == 32
    ref_p, p, x = _layer(rcfg, 0, (2, 64, cfg.d_model))
    got, aux, want, want_aux = _both(rcfg, cfg, ref_p, p, x,
                                     capacity_factor=0.5)
    assert np.isfinite(got).all()
    zero = ~got.reshape(128, -1).any(-1)
    np.testing.assert_array_equal(zero,
                                  ~want.reshape(128, -1).any(-1))
    assert 0 < zero.sum() < 128
    _close(got, want, TOL)
    _close(aux, want_aux, VALUE_TOL)
    tiny, _, want_tiny, _ = _both(rcfg, cfg, ref_p, p, x,
                                  capacity_factor=0.05)
    _close(tiny, want_tiny, TOL)
    full, _, _, _ = _both(rcfg, cfg, ref_p, p, x, capacity_factor=16.0)
    assert np.linalg.norm(tiny) <= np.linalg.norm(got) <= \
        np.linalg.norm(full) + 1e-3


def test_aux_loss_balanced_vs_collapsed_router():
    """The router as drawn gives an aux loss near 1; collapsed onto expert
    0 it gives more; both equal the reference's."""
    rcfg, cfg = _cfgs(e=4, k=1)
    ref_p, p, x = _layer(rcfg, 1, (2, 128, cfg.d_model))
    got, aux, want, want_aux = _both(rcfg, cfg, ref_p, p, x)
    _close(aux, want_aux, VALUE_TOL)
    ref_p = dict(ref_p, router=jnp.zeros_like(ref_p["router"]).at[:, 0].set(
        10.0))
    p = dict(p, router=lm_params_from_jax(ref_p["router"]))
    _, collapsed, _, want_collapsed = _both(rcfg, cfg, ref_p, p, x)
    _close(collapsed, want_collapsed, VALUE_TOL)
    assert collapsed > aux > 0.5


def test_shared_experts_add_the_dense_path():
    rcfg, cfg = _cfgs(e=4, k=2, shared=1)
    ref_p, p, x = _layer(rcfg, 2, (1, 16, cfg.d_model))
    assert "shared" in p and p["shared"]["w_up"].shape == (
        cfg.d_model, cfg.moe_d_ff)
    got, aux, want, want_aux = _both(rcfg, cfg, ref_p, p, x)
    assert got.shape == x.shape
    _close(got, want, TOL)
    _close(aux, want_aux, VALUE_TOL)
    routed, _ = moe.moe_forward(cfg, {k: v for k, v in p.items()
                                      if k != "shared"}, torch.from_numpy(x))
    assert not np.allclose(routed.numpy(), got, atol=1e-3)


def test_one_dispatch_group_ignores_the_batch_shape():
    """The port runs one dispatch group (the reference's count without a
    mesh), so [4, 16] and [2, 32] tokens give the same outputs bit for
    bit."""
    _, cfg = _cfgs(e=4, k=2)
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg)
    x = 0.3 * torch.randn((4, 16, cfg.d_model),
                          generator=torch.Generator().manual_seed(4))
    o1, a1 = moe.moe_forward(cfg, p, x, capacity_factor=16.0)
    o2, a2 = moe.moe_forward(cfg, p, x.reshape(2, 32, -1),
                             capacity_factor=16.0)
    assert torch.equal(o1.reshape(-1), o2.reshape(-1))
    assert torch.equal(a1, a2)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b"])
def test_capacity_equals_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for n in (1, 4, 7, 64, 2048, 4096):
        for cf in (None, 0.05, 0.5, 1.0, 8.0):
            assert moe.moe_capacity(cfg, n, cf) == \
                ref_moe.moe_capacity(rcfg, n, cf)


def test_bf16_layer_keeps_the_router_in_fp32():
    """In a bf16 model the router leaf and its softmax stay fp32; the
    output is bf16 and agrees with the reference's bf16 layer."""
    rcfg, cfg = _cfgs(e=4, k=2, shared=1, dtype="bfloat16")
    ref_p, p, x = _layer(rcfg, 5, (2, 16, cfg.d_model))
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == torch.bfloat16
    out, _ = moe.moe_forward(cfg, p, torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    got, aux, want, want_aux = _both(rcfg, cfg, ref_p, p, x)
    _close(got, want, 2e-2)
    _close(aux, want_aux, VALUE_TOL)


GROUPED_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro.configs
from repro.models import hooks, moe
from repro.models.base import get_config
cfg = get_config("deepseek-moe-16b", smoke=True).replace(
    n_experts=4, experts_per_token=2, n_shared_experts=1, dtype="float32")
p = moe.init_moe(jax.random.PRNGKey(5), cfg)
x = np.load(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
hooks.set_activation_sharding(("data",), "model")
with jax.set_mesh(mesh):
    assert hooks.data_axis_size() == 2
    out, aux = jax.jit(lambda p, x: moe.moe_forward(
        cfg, p, x, capacity_factor=0.5))(p, jnp.asarray(x))
np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(aux))
"""


@requires_set_mesh
def test_two_dispatch_groups_match_the_reference_under_its_hooks(tmp_path):
    """The reference's grouped dispatch with its hooks on a 2-device data
    axis (G 2, each group its own capacity; a capacity factor that drops
    tokens) against the port's ``groups=2``; the port's single group
    differs from it where a token is dropped."""
    import os
    import subprocess
    import sys

    rcfg, cfg = _cfgs(e=4, k=2, shared=1)
    ref_p, p, _ = _layer(rcfg, 5, (1, 1, cfg.d_model))
    x = (0.3 * np.random.default_rng(7).normal(
        size=(4, 16, cfg.d_model))).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    run = subprocess.run(
        [sys.executable, "-c", GROUPED_SCRIPT, str(tmp_path / "x.npy"),
         str(tmp_path / "out.npz")], env=dict(os.environ, PYTHONPATH=src),
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    got, aux = moe.moe_forward(cfg, p, torch.from_numpy(x),
                               capacity_factor=0.5, groups=2)
    _close(got.numpy(), want["out"], TOL)
    _close(float(aux), float(want["aux"]), VALUE_TOL)
    one, _ = moe.moe_forward(cfg, p, torch.from_numpy(x),
                             capacity_factor=0.5)
    assert not np.allclose(one.numpy(), want["out"], atol=TOL)
