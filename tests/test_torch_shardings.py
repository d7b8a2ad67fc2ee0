"""The port's partition rules (``repro_torch.launch.shardings``) against
the reference's (``repro.launch.shardings``), spec for spec, for all ten
architectures at full size on the reference's production meshes: the
parameters (the port's on fake tensors, the reference's on
``jax.eval_shape``) with and without FSDP and FACADE's node axis, the
FACADE heads' ``extra_leading``, the optimizer slots, and the batches
and caches of the four input shapes. The rules read only the mesh's axis
sizes, so both take the reference's duck-typed ``FakeMesh``."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

import repro.configs  # noqa: F401  (registry)
import repro_torch.configs  # noqa: F401  (registry)
from repro.launch import shardings as ref_sh
from repro.launch import steps as ref_steps
from repro.models import api as ref_api
from repro.models import transformer as ref_tf
from repro.models.base import get_config as ref_get_config
from repro.models.base import list_archs
from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch import shardings, steps
from repro_torch.models import api, transformer
from repro_torch.models.base import get_config

torch.set_num_threads(1)


class FakeMesh:
    """Duck-typed mesh: the rules read only ``.shape``."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {"pod16x16": FakeMesh(data=16, model=16),
          "pod2x16x16": FakeMesh(pod=2, data=16, model=16)}
ARCHS = list_archs()


class Shape:
    """A leaf that only has a shape, for specs of stacked shapes."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _ref_specs(tree) -> dict:
    """path -> spec tuple of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {ref_sh._path_str(path): tuple(spec) for path, spec in flat}


def _port_specs(tree) -> dict:
    flat, _ = pytree.tree_flatten_with_path(tree, is_leaf=shardings.is_spec)
    return {shardings._path_str(path): spec for path, spec in flat}


def _shapes(tree) -> dict:
    """path -> shape of a port tree (fake tensors or ``Shape``)."""
    flat, _ = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "shape"))
    return {shardings._path_str(p): tuple(x.shape) for p, x in flat
            if hasattr(x, "shape")}


@functools.cache
def _params(arch: str):
    """(the port's fake parameters, the reference's ShapeDtypeStructs)."""
    with FakeTensorMode():
        port = api.init_params(get_config(arch), torch.Generator())
    rcfg = ref_get_config(arch)
    ref = jax.eval_shape(lambda k: ref_api.init_params(rcfg, k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    return port, ref


def _stacked(tree, lead: tuple):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(lead + s.shape,
                                                       s.dtype), tree)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    """Every leaf's spec, with and without FSDP and the node axis; the
    FACADE heads' ``[n, k, ...]`` leaves with ``extra_leading``."""
    mesh = MESHES[mesh_name]
    port, ref = _params(arch)
    shapes = _shapes(port)
    assert shapes == {ref_sh._path_str(p): tuple(s.shape) for p, s in
                      jax.tree_util.tree_flatten_with_path(ref)[0]}
    for fsdp in (True, False):
        want = _ref_specs(ref_sh.param_specs(ref, mesh, fsdp=fsdp))
        assert _port_specs(shardings.param_specs(port, mesh,
                                                 fsdp=fsdp)) == want
        stacked = pytree.tree_map(lambda x: Shape((2,) + tuple(x.shape)),
                                  port)
        want = _ref_specs(ref_sh.param_specs(_stacked(ref, (2,)), mesh,
                                             fsdp=fsdp, node_axis=True))
        assert _port_specs(shardings.param_specs(
            stacked, mesh, fsdp=fsdp, node_axis=True)) == want
    pod = "pod" if "pod" in mesh.shape else None
    for key in ("final_norm", "lm_head", "embed"):
        if key not in shapes:
            continue
        shape = (2, 2) + shapes[key]
        assert shardings.leaf_spec(key, shape, mesh, extra_leading=(
            pod, None)) == tuple(ref_sh.leaf_spec(
                key, shape, mesh, extra_leading=(pod, None)))


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_the_reference(arch):
    mesh = MESHES["pod16x16"]
    port, ref = _params(arch)
    ropt = ref_steps.make_optimizer(arch, ref_get_config(arch))
    ref_state = jax.eval_shape(ropt.init, ref)
    with FakeTensorMode():
        state = steps.make_optimizer(arch, get_config(arch)).init(port)
    want = _ref_specs(ref_sh.opt_specs(ref_state, ref_sh.param_specs(
        ref, mesh)))
    got = _port_specs(shardings.opt_specs(state, shardings.param_specs(
        port, mesh)))
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh_name):
    """The batches of the four input shapes (plain and node-stacked) and
    the decode shapes' caches."""
    mesh = MESHES[mesh_name]
    for shape_name, shp in INPUT_SHAPES.items():
        if not steps.is_supported(arch, shape_name):
            continue
        rcfg = ref_steps.resolve_config(arch, shape_name)
        cfg = steps.resolve_config(arch, shape_name)
        b, s = shp.global_batch, shp.seq_len
        ref_batch = ref_steps._lm_batch_sds(rcfg, b, s)
        with FakeTensorMode():
            batch = steps._lm_batch(cfg, b, s, torch.Generator())
        assert _port_specs(shardings.batch_specs(batch, mesh)) == \
            _ref_specs(ref_sh.batch_specs(ref_batch, mesh))
        stacked = pytree.tree_map(lambda x: Shape((2,) + tuple(x.shape)),
                                  batch)
        assert _port_specs(shardings.batch_specs(
            stacked, mesh, node_axis=True)) == _ref_specs(
                ref_sh.batch_specs(_stacked(ref_batch, (2,)), mesh,
                                   node_axis=True))
        if shp.kind != "decode":
            continue
        if cfg.encoder_layers > 0:
            n = min(s, cfg.max_decoder_len)
            with FakeTensorMode():
                cache = steps._whisper_cache(cfg, b, n, "cpu")
            ref_cache = pytree.tree_map(lambda x: jax.ShapeDtypeStruct(
                tuple(x.shape), jnp.float32), cache)
        else:
            n = transformer.cache_physical_len(cfg, s)
            assert n == ref_tf.cache_physical_len(rcfg, s)
            with FakeTensorMode():
                cache = transformer.init_cache(cfg, b, n, "cpu")
            ref_cache = jax.eval_shape(
                lambda: ref_tf.init_cache(rcfg, b, n))
        assert _shapes(cache) == {
            ref_sh._path_str(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(ref_cache)[0]}
        assert _port_specs(shardings.cache_specs(cache, mesh)) == \
            _ref_specs(ref_sh.cache_specs(ref_cache, mesh))


@pytest.mark.parametrize("shape", [(8,), (8, 3), (3, 8), (), (8, 2, 2)])
def test_node_carry_specs_equal_the_reference(shape):
    from repro.core import meshctx as ref_meshctx
    tree = {"a": torch.zeros(shape), "b": {"c": torch.zeros((8, 5))}}
    got = shardings.node_carry_specs(tree, 8)
    want = {"a": tuple(ref_meshctx.node_spec(jnp.zeros(shape), 8)),
            "b": {"c": tuple(ref_meshctx.node_spec(jnp.zeros((8, 5)),
                                                   8))}}
    assert got == want


def test_placements_of_a_spec():
    """A spec's placements over a mesh: each named axis shards its tensor
    dim (a tuple entry over several axes), the others replicate."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 2)

    assert shardings.placements((("pod", "data"), None, "model"), Mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert shardings.placements((None, "data"), Mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert shardings.placements((), Mesh) == (Replicate(),) * 3
    assert shardings.local_shape((16, 6, 4), (("pod", "data"), None,
                                              "model"), Mesh) == (2, 6, 2)
