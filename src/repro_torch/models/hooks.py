"""Activation-sharding hooks (the counterpart of ``repro.models.hooks``).

Model code is mesh-agnostic; a launcher opts in by installing axis names
here. Each hook is a no-op unless axes are installed AND the tensor is a
DTensor on a ``DeviceMesh`` that has those axes AND the dimension divides,
so every plain-tensor path (one card, the CPU tests) runs as before, bit
for bit.

The anchors pin, as the reference's ``with_sharding_constraint`` does:
  * the residual stream's batch dim to the data axes,
  * attention's head dims to the model axis.

A constraint here is ``DTensor.redistribute`` to the placements the
reference's ``PartitionSpec`` names: the dims it names are sharded, every
other mesh dim is replicated (a ``Partial`` sum is reduced).
"""
from __future__ import annotations

import contextlib

_BATCH_AXES: tuple | None = None
_MODEL_AXIS: str | None = None
_SEQ_MODEL: bool = False


def set_activation_sharding(batch_axes, model_axis=None,
                            seq_model: bool = False) -> None:
    """``seq_model=True`` also shards dim 1 (the sequence) of the residual
    stream on the model axis: Megatron-style sequence parallelism for the
    saved activations."""
    global _BATCH_AXES, _MODEL_AXIS, _SEQ_MODEL
    _BATCH_AXES = tuple(batch_axes) if batch_axes else None
    _MODEL_AXIS = model_axis
    _SEQ_MODEL = seq_model


def clear() -> None:
    set_activation_sharding(None, None)


@contextlib.contextmanager
def installed(batch_axes, model_axis=None, seq_model: bool = False):
    """The hooks set as :func:`set_activation_sharding` sets them while
    the context is open, and put back as they were after it."""
    global _BATCH_AXES, _MODEL_AXIS, _SEQ_MODEL
    old = (_BATCH_AXES, _MODEL_AXIS, _SEQ_MODEL)
    set_activation_sharding(batch_axes, model_axis, seq_model)
    try:
        yield
    finally:
        _BATCH_AXES, _MODEL_AXIS, _SEQ_MODEL = old


def active() -> bool:
    return _BATCH_AXES is not None or _MODEL_AXIS is not None


def _axes_of(x) -> dict | None:
    """``{axis: size}`` of x's mesh when x is a DTensor whose mesh has
    every installed axis, else None."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    axes = dict(zip(mesh.mesh_dim_names or (), (int(s) for s in
                                               mesh.shape)))
    need = set(_BATCH_AXES or ()) | ({_MODEL_AXIS} if _MODEL_AXIS else set())
    return axes if need <= set(axes) else None


def _axis_size(axes: dict, names) -> int:
    n = 1
    for a in (names if isinstance(names, tuple) else (names,)):
        n *= axes.get(a, 1)
    return n


def data_axis_size(x=None) -> int:
    """The size of the data axes of x's mesh (1 when the hooks are off or
    x is not a DTensor on such a mesh): the MoE grouped dispatch's group
    count."""
    if _BATCH_AXES is None:
        return 1
    axes = _axes_of(x)
    return 1 if axes is None else _axis_size(axes, _BATCH_AXES)


def _constrain(x, spec):
    from repro_torch.launch.shardings import placements

    want = placements(tuple(spec), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _batch_entry():
    return _BATCH_AXES if len(_BATCH_AXES) > 1 else _BATCH_AXES[0]


def shard_batch(x, batch_dim: int = 0):
    """Constrain x's batch dim onto the data axes (replicated elsewhere;
    with seq_model also dim batch_dim+1 onto the model axis)."""
    if _BATCH_AXES is None:
        return x
    axes = _axes_of(x)
    if axes is None or x.shape[batch_dim] % _axis_size(axes, _BATCH_AXES):
        return x
    spec = [None] * x.ndim
    spec[batch_dim] = _batch_entry()
    if (_SEQ_MODEL and _MODEL_AXIS and x.ndim > batch_dim + 1
            and x.shape[batch_dim + 1] % axes[_MODEL_AXIS] == 0):
        spec[batch_dim + 1] = _MODEL_AXIS
    return _constrain(x, spec)


def shard_heads(x, batch_dim: int = 0, head_dim: int = 2,
                seq_dim: int | None = None):
    """Constrain ``[B, S, H, D]``-shaped activations: batch -> data, heads
    -> model.

    When the head count does not divide the model axis (llava's 56 heads,
    hymba's 25 on a 16-way axis), shard a sequence dim on 'model' instead
    (``seq_dim``, for example the q dim of a ``[B, H, Sq, Skv]`` score
    block); softmax axes stay unsharded."""
    if not active():
        return x
    axes = _axes_of(x)
    if axes is None:
        return x
    spec = [None] * x.ndim
    if _BATCH_AXES and x.shape[batch_dim] % _axis_size(axes,
                                                      _BATCH_AXES) == 0:
        spec[batch_dim] = _batch_entry()
    if _MODEL_AXIS:
        msize = axes[_MODEL_AXIS]
        if x.shape[head_dim] % msize == 0:
            spec[head_dim] = _MODEL_AXIS
        elif seq_dim is not None and x.shape[seq_dim] % msize == 0:
            spec[seq_dim] = _MODEL_AXIS
    if all(s is None for s in spec):
        return x
    return _constrain(x, spec)
