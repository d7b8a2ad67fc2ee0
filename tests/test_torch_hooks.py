"""The port's activation-sharding hooks (``repro_torch.models.hooks``):
no-ops when not installed, when cleared and on plain tensors; on an
8-rank fake world with a (data 4, model 2) mesh, ``shard_batch`` and
``shard_heads`` redistribute to the placements that the reference's
constraints name in its own cases (``tests/test_hooks.py``): the batch on
'data' and, with ``seq_model``, the sequence on 'model'; an indivisible
batch left as it is; heads that do not divide the model axis fall back
to the sequence dim."""
from __future__ import annotations

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.models import hooks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    with fake_world(8):
        yield make_debug_mesh((4, 2), ("data", "model"), device="cpu")


def teardown_function(_fn):
    hooks.clear()


def _rep(mesh, shape):
    return DTensor.from_local(torch.ones(shape), mesh,
                              [Replicate(), Replicate()], run_check=False)


def test_noop_on_plain_tensors():
    hooks.set_activation_sharding(("data",), "model", seq_model=True)
    x = torch.ones(8, 6, 3)
    assert hooks.shard_batch(x) is x
    h = torch.ones(8, 6, 4, 2)
    assert hooks.shard_heads(h, seq_dim=1) is h
    assert hooks.data_axis_size(x) == 1


def test_noop_when_not_installed_or_cleared(mesh):
    x = _rep(mesh, (8, 6, 3))
    assert hooks.shard_batch(x) is x and hooks.shard_heads(x) is x
    assert hooks.data_axis_size(x) == 1
    hooks.set_activation_sharding(("data",), "model")
    hooks.clear()
    assert hooks.shard_batch(x) is x
    assert hooks.shard_heads(_rep(mesh, (8, 6, 4, 2))).placements == \
        (Replicate(), Replicate())
    assert hooks.data_axis_size(x) == 1


def test_noop_on_a_mesh_without_the_axes(mesh):
    hooks.set_activation_sharding(("pod", "data"), "model")
    x = _rep(mesh, (8, 6, 3))
    assert hooks.shard_batch(x) is x
    assert hooks.data_axis_size(x) == 1


def test_the_reference_cases(mesh):
    """``tests/test_hooks.py::test_constraints_inside_mesh``."""
    hooks.set_activation_sharding(("data",), "model", seq_model=True)
    # divisible batch (8 % 4) and sequence (6 % 2): P('data', 'model')
    y = hooks.shard_batch(_rep(mesh, (8, 6, 3)))
    assert y.placements == (Shard(0), Shard(1))
    assert y.to_local().shape == (2, 3, 3)
    # indivisible batch: no constraint
    x = _rep(mesh, (3, 6, 3))
    assert hooks.shard_batch(x) is x
    # 5 heads do not divide 2: the sequence dim takes 'model'
    z = hooks.shard_heads(_rep(mesh, (8, 6, 5, 4)), head_dim=2, seq_dim=1)
    assert z.placements == (Shard(0), Shard(1))
    assert hooks.data_axis_size(x) == 4


def test_shard_heads_puts_heads_on_model(mesh):
    hooks.set_activation_sharding(("data",), "model")
    z = hooks.shard_heads(_rep(mesh, (8, 6, 4, 2)))
    assert z.placements == (Shard(0), Shard(2))
    # a [B, H, Sq, Skv] score block: heads at dim 1
    s = hooks.shard_heads(_rep(mesh, (8, 4, 6, 6)), head_dim=1, seq_dim=2)
    assert s.placements == (Shard(0), Shard(1))
    # neither heads nor the sequence divide: batch only
    w = hooks.shard_heads(_rep(mesh, (8, 3, 5, 2)), seq_dim=1)
    assert w.placements == (Shard(0), Replicate())
    # nothing divides: as it is
    v = _rep(mesh, (3, 3, 5, 2))
    assert hooks.shard_heads(v, seq_dim=1) is v


def test_without_seq_model_the_sequence_is_replicated(mesh):
    hooks.set_activation_sharding(("data",), "model")
    y = hooks.shard_batch(_rep(mesh, (8, 6, 3)))
    assert y.placements == (Shard(0), Replicate())


def test_installed_puts_the_hooks_back():
    hooks.set_activation_sharding(("data",), "model")
    with hooks.installed(("pod", "data"), "model", seq_model=True):
        assert hooks._BATCH_AXES == ("pod", "data") and hooks._SEQ_MODEL
    assert hooks._BATCH_AXES == ("data",) and not hooks._SEQ_MODEL
