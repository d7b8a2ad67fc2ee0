"""Parameter conversion between the JAX reference and the port.

The reference stores conv kernels HWIO (``repro.models.cnn.conv_init``);
the port stores them OIHW, PyTorch's layout. Dense weights stay
``[d_in, d_out]`` and norm/bias vectors are unchanged. Trees are nested
dicts; ``lead`` counts the stacked axes in front of each leaf (0 for one
model, 1 for node-stacked cores, 2 for node-and-cluster-stacked heads), so
a conv kernel is any leaf with ``lead + 4`` dims.

Language-model trees (``lm_params_from_jax`` / ``lm_params_to_jax``) have
no conv kernels: every leaf crosses as it is, stacked ``[L, ...]`` layers
included. A JAX bf16 array reaches numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, so bf16 crosses bit for bit as ``uint16``.
"""
from __future__ import annotations

import numpy as np
import torch

from .tree import tree_map


def params_from_jax(tree, lead: int = 0):
    """Reference tree of numpy arrays (HWIO convs) -> CPU tensors (OIHW)."""
    def conv(a):
        a = np.asarray(a)
        if a.ndim == lead + 4:                       # [..., H, W, I, O]
            a = np.moveaxis(a, (lead + 2, lead + 3), (lead + 1, lead))
        return torch.from_numpy(np.array(a))        # a writable copy

    return tree_map(conv, tree)


def params_to_jax(tree, lead: int = 0):
    """Inverse of :func:`params_from_jax`: tensors (OIHW) -> numpy (HWIO)."""
    def conv(t):
        a = t.detach().cpu().numpy()
        if a.ndim == lead + 4:                       # [..., O, I, H, W]
            a = np.moveaxis(a, (lead, lead + 1), (lead + 3, lead + 2))
        return np.ascontiguousarray(a)

    return tree_map(conv, tree)


def _lm_leaf_from_jax(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":             # ml_dtypes.bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))        # a writable copy


def _lm_leaf_to_jax(t) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                        # shipped with JAX
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def lm_params_from_jax(tree):
    """Reference language-model tree (JAX or numpy leaves) -> CPU tensors,
    every leaf as it is (no transposition), bf16 bit for bit."""
    return tree_map(_lm_leaf_from_jax, tree)


def lm_params_to_jax(tree):
    """Inverse of :func:`lm_params_from_jax`: tensors -> numpy arrays
    (``ml_dtypes.bfloat16`` for bf16 leaves)."""
    return tree_map(_lm_leaf_to_jax, tree)
