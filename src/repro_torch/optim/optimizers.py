"""Minimal optimizers over nested dicts of tensors (the port's copy of
``repro.optim.optimizers``).

Each optimizer is an (init, update) pair:
    opt.init(params)                     -> opt_state
    opt.update(grads, state, params)     -> (updates, new_state)
apply_updates(params, updates)           -> params - updates already scaled.

``state["count"]`` is the number of updates made so far, a Python int: a
callable ``lr`` is read at the count before the update, and AdamW's bias
correction uses the count after it, as in the reference. Updates are
fp32; ``slot_dtype`` sets the dtype the moments are kept in (fp32 by
default; bf16 halves their memory). Call ``update`` under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p - u).to(p.dtype), params, updates)


def _lr_at(lr, count: int):
    return lr(count) if callable(lr) else lr


def _zeros(dtype):
    return lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)


def sgd(lr) -> Optimizer:
    def init(params):
        return {"count": 0}

    def update(grads, state, params=None):
        step = _lr_at(lr, state["count"])
        ups = tree_map(lambda g: step * g.float(), grads)
        return ups, {"count": state["count"] + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9,
             slot_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"count": 0, "m": tree_map(_zeros(slot_dtype), params)}

    def update(grads, state, params=None):
        m = tree_map(lambda mm, g: (beta * mm.float() + g.float())
                     .to(slot_dtype), state["m"], grads)
        step = _lr_at(lr, state["count"])
        ups = tree_map(lambda mm: step * mm.float(), m)
        return ups, {"count": state["count"] + 1, "m": m}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, slot_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"count": 0, "m": tree_map(_zeros(slot_dtype), params),
                "v": tree_map(_zeros(slot_dtype), params)}

    def update(grads, state, params):
        c = state["count"] + 1
        m = tree_map(lambda mm, g: (b1 * mm.float() + (1 - b1) * g.float())
                     .to(slot_dtype), state["m"], grads)
        v = tree_map(lambda vv, g: (b2 * vv.float()
                                    + (1 - b2) * g.float().square())
                     .to(slot_dtype), state["v"], grads)
        # the bias corrections in fp32, as the reference computes them
        bc1 = float(1 - np.float32(b1) ** np.float32(c))
        bc2 = float(1 - np.float32(b2) ** np.float32(c))
        step = _lr_at(lr, state["count"])

        def upd(mm, vv, p):
            u = (mm.float() / bc1) / ((vv.float() / bc2).sqrt() + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return step * u

        ups = tree_map(upd, m, v, params)
        return ups, {"count": c, "m": m, "v": v}

    return Optimizer(init, update)
