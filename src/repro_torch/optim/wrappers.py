"""Optimizer wrappers: master-weight mixed precision, gradient clipping
and gradient accumulation (the port's copy of ``repro.optim.wrappers``).

``master_weights(opt)`` keeps an fp32 master copy of (bf16) params in the
optimizer state: the update runs on the master, and the delta it returns
takes the params exactly onto the master rounded to their dtype, so bf16
rounding never accumulates.

``clip_by_global_norm`` composes in front of any optimizer.

``accumulate_gradients(loss_fn, params, batches)`` folds a leading
microbatch axis, one backward pass per microbatch.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .optimizers import Optimizer


def master_weights(opt: Optimizer) -> Optimizer:
    """Wrap ``opt`` with fp32 master params; ``update`` returns the delta
    for :func:`apply_updates` as usual."""

    def init(params):
        return {"inner": opt.init(params),
                "master": tree_map(lambda p: p.float(), params)}

    def update(grads, state, params):
        ups, inner = opt.update(grads, state["inner"], state["master"])
        master = tree_map(lambda mp, u: mp - u.float(), state["master"], ups)
        # the delta that takes the current params exactly onto the master
        delta = tree_map(lambda p, mp: p.float() - mp, params, master)
        return delta, {"inner": inner, "master": master}

    return Optimizer(init, update)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    def init(params):
        return opt.init(params)

    def update(grads, state, params):
        norm = torch.sqrt(sum(g.float().square().sum()
                              for g in tree_leaves(grads)))
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
        return opt.update(grads, state, params)

    return Optimizer(init, update)


def accumulate_gradients(loss_fn, params, batches):
    """Mean loss and gradients over a leading microbatch axis.

    ``loss_fn(params, micro) -> (loss, aux)``; ``batches`` is a dict of
    tensors with leading ``[n_micro, ...]``. Returns ``((loss,
    aux_of_last_micro), grads)`` as ``jax.value_and_grad(...,
    has_aux=True)`` would: the gradients are summed in fp32 and cast to
    each param's dtype, the loss is fp32.
    """
    n = next(iter(tree_leaves(batches))).shape[0]
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32)
    aux = None
    for i in range(n):
        with torch.enable_grad():
            loss, aux = loss_fn(tree, tree_map(lambda b: b[i], batches))
            grads = torch.autograd.grad(loss, leaves)
        g_acc = [a + g.float() / n for a, g in zip(g_acc, grads)]
        loss_acc = loss_acc.to(loss.device) + loss.detach().float() / n
    grads = [g.to(p.dtype) for g, p in zip(g_acc, leaves)]
    aux = tree_map(lambda a: a.detach() if torch.is_tensor(a) else a, aux)
    return (loss_acc, aux), tree_unflatten(params, grads)
