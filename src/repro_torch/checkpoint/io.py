"""Tree checkpointing to ``.npz`` (the port's copy of
``repro.checkpoint.io``, in the same file format, so a file written by
either package loads in the other).

Paths are '/'-joined tree keys; dicts, lists, tuples and ``None`` round-trip
exactly (NamedTuples come back as tuples). Leaves are tensors on any device,
numpy arrays or Python scalars; :func:`load` returns every leaf as a CPU
tensor. npz has no bf16, so bf16 leaves are stored as their raw ``uint16``
bits with the dtype recorded in the ``__struct__`` JSON, beside the
caller's ``__meta__`` JSON.

:func:`save` is atomic: the archive is written to ``<path>.tmp`` and
``os.replace``'d over ``path``, so a run killed mid-save leaves either the
previous complete checkpoint or none at all. A truncated or foreign file
at load time raises :class:`CheckpointError` naming the path.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


class CheckpointError(ValueError):
    """A checkpoint file exists but cannot be parsed (corrupt/truncated,
    or not a repro checkpoint at all)."""


def _leaf(x):
    """(numpy array to store, its dtype name)."""
    if torch.is_tensor(x):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _flatten(tree, flat: dict, prefix=""):
    """Fill ``flat`` with the leaves of ``tree`` by path; returns the
    structure (the ``__struct__`` JSON)."""
    if tree is None:
        return {"__kind__": "none"}
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _flatten(tree[k], flat, f"{prefix}{k}/")
                          for k in tree}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_flatten(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(tree)]}
    flat[prefix[:-1]], dtype = _leaf(tree)
    return {"__kind__": "leaf", "dtype": dtype}


def save(path: str, tree, meta: dict | None = None):
    """Atomically write ``tree`` (and a small JSON-able ``meta`` dict) to
    ``path``."""
    flat = {}
    struct = _flatten(tree, flat)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta or {}),
                     __struct__=json.dumps(struct), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _rebuild(struct, flat, prefix=""):
    kind = struct["__kind__"]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _rebuild(v, flat, f"{prefix}{k}/")
                for k, v in struct["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_rebuild(v, flat, f"{prefix}{i}/")
               for i, v in enumerate(struct["items"])]
        return tuple(seq) if kind == "tuple" else seq
    arr = flat[prefix[:-1]]
    if struct.get("dtype") == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load(path: str):
    """-> (tree with CPU tensor leaves, meta dict)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    try:
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files
                    if k not in ("__meta__", "__struct__")}
            struct = json.loads(str(z["__struct__"]))
            meta = json.loads(str(z["__meta__"]))
        return _rebuild(struct, flat), meta
    except (FileNotFoundError, CheckpointError):
        raise
    except Exception as e:
        raise CheckpointError(
            f"corrupt or truncated checkpoint at {path!r} "
            f"({type(e).__name__}: {e}); delete it to restart the run "
            "from scratch") from e
