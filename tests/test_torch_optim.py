"""The port's optimizers, schedules and wrappers against the reference's
(``repro.optim``) on a small random tree: the same gradients go through
both for 5 steps, and each step's updates and the params after
``apply_updates`` are compared.

Tolerance: 1e-6 absolute on the updates and fp32 params (updates are of
the order of the learning rate; the two packages compute the same fp32
expressions, the port's schedules in float64); bf16 params and slots are
held to one bf16 ulp of their value (2^-8 relative), since an fp32
difference of an ulp can round either way."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim
from repro_torch.tree import tree_map

torch.set_num_threads(1)
TOL = 1e-6
BF16_RTOL = 2.0 ** -8
STEPS = 5


def _tree(seed, bf16=False):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(4, 3)), "b": rng.normal(size=(3,)),
            "blk": {"g": rng.normal(size=(2, 2, 5))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    if bf16:
        tree["w"] = np.asarray(jnp.asarray(tree["w"], jnp.bfloat16))
    return tree


def _to_torch(tree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, tree)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        jnp.asarray(t, jnp.float32))


def _assert_close(got, want, bf16=False):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        if bf16 and str(getattr(w, "dtype", "")) == "bfloat16":
            np.testing.assert_allclose(_np(g), _np(w), rtol=BF16_RTOL,
                                       atol=TOL)
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=TOL)


def _run(make_ref, make_port, bf16=False, grad_scale=1.0):
    params = _tree(0, bf16)
    ref_opt, port_opt = make_ref(), make_port()
    rp, pp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    rs, ps = ref_opt.init(rp), port_opt.init(pp)
    for step in range(STEPS):
        grads = jax.tree.map(lambda a: grad_scale * a.astype(np.float32),
                             _tree(100 + step))
        ru, rs = ref_opt.update(jax.tree.map(jnp.asarray, grads), rs, rp)
        with torch.no_grad():
            pu, ps = port_opt.update(_to_torch(grads), ps, pp)
        _assert_close(pu, ru)
        rp, pp = ref_optim.apply_updates(rp, ru), optim.apply_updates(pp, pu)
        _assert_close(pp, rp, bf16)
        assert [p.dtype for p in jax.tree.leaves(pp)] == [
            p.dtype for p in jax.tree.leaves(_to_torch(params))]
    return rs, ps


@pytest.mark.parametrize("name", ["sgd", "sgd-schedule", "momentum",
                                  "momentum-bf16-slots", "adamw",
                                  "adamw-cosine-decay", "adamw-bf16-slots"])
def test_optimizer_matches_the_reference(name):
    sched = (ref_optim.cosine_warmup(0.1, 2, 5, floor=0.01),
             optim.cosine_warmup(0.1, 2, 5, floor=0.01))
    make = {
        "sgd": (lambda: ref_optim.sgd(0.1), lambda: optim.sgd(0.1)),
        "sgd-schedule": (lambda: ref_optim.sgd(ref_optim.constant(0.2)),
                         lambda: optim.sgd(optim.constant(0.2))),
        "momentum": (lambda: ref_optim.momentum(0.05),
                     lambda: optim.momentum(0.05)),
        "momentum-bf16-slots": (
            lambda: ref_optim.momentum(0.05, slot_dtype=jnp.bfloat16),
            lambda: optim.momentum(0.05, slot_dtype=torch.bfloat16)),
        "adamw": (lambda: ref_optim.adamw(0.01), lambda: optim.adamw(0.01)),
        "adamw-cosine-decay": (
            lambda: ref_optim.adamw(sched[0], weight_decay=0.1),
            lambda: optim.adamw(sched[1], weight_decay=0.1)),
        "adamw-bf16-slots": (
            lambda: ref_optim.adamw(0.01, slot_dtype=jnp.bfloat16),
            lambda: optim.adamw(0.01, slot_dtype=torch.bfloat16)),
    }[name]
    rs, ps = _run(*make)
    assert ps["count"] == int(rs["count"]) == STEPS
    for key in ("m", "v"):
        if key in rs:
            assert all(a.dtype == (torch.bfloat16 if "bf16" in name
                                   else torch.float32)
                       for a in jax.tree.leaves(ps[key]))
            _assert_close(ps[key], rs[key], bf16=True)


def test_schedules_match_the_reference():
    ref = ref_optim.cosine_warmup(0.3, 3, 10, floor=0.02)
    port = optim.cosine_warmup(0.3, 3, 10, floor=0.02)
    for count in range(13):
        np.testing.assert_allclose(port(count),
                                   float(ref(jnp.asarray(count, jnp.int32))),
                                   rtol=1e-6)
    assert optim.constant(0.5)(7) == float(ref_optim.constant(0.5)(7))


def test_master_weights_over_bf16_params():
    """fp32 master copies of bf16 params: the params land exactly on the
    master rounded to bf16, as the reference's."""
    rs, ps = _run(lambda: ref_optim.master_weights(ref_optim.adamw(0.01)),
                  lambda: optim.master_weights(optim.adamw(0.01)), bf16=True)
    _assert_close(ps["master"], rs["master"])
    assert ps["inner"]["count"] == STEPS


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm(max_norm):
    _run(lambda: ref_optim.clip_by_global_norm(ref_optim.sgd(0.1), max_norm),
         lambda: optim.clip_by_global_norm(optim.sgd(0.1), max_norm),
         grad_scale=3.0)


def test_accumulate_gradients():
    """Mean loss and fp32-summed gradients over 3 microbatches, and the
    last microbatch's aux, as the reference's ``lax.scan``."""
    params = _tree(1)
    rng = np.random.default_rng(2)
    batches = {"x": rng.normal(size=(3, 6, 4)).astype(np.float32),
               "y": rng.normal(size=(3, 6, 3)).astype(np.float32)}

    def loss_fn(p, mb):
        pred = mb["x"] @ p["w"] + p["b"]
        loss = ((pred - mb["y"]) ** 2).mean() + (p["blk"]["g"] ** 2).sum()
        return loss, {"pred0": pred[0, 0]}

    (rl, raux), rg = ref_optim.accumulate_gradients(
        loss_fn, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batches))
    (pl, paux), pg = optim.accumulate_gradients(
        loss_fn, _to_torch(params),
        tree_map(torch.from_numpy, batches))
    np.testing.assert_allclose(pl.item(), float(rl), rtol=1e-6)
    np.testing.assert_allclose(paux["pred0"].item(), float(raux["pred0"]),
                               rtol=1e-6)
    assert not paux["pred0"].requires_grad
    _assert_close(pg, rg)
