"""The language models' mesh on one card: ``make_debug_mesh((1, 1))``
over a one-rank NCCL group (started by the mesh itself), llama3.2-1b's
and rwkv6-1.6b's smoke steps built by ``launch.steps.build_case(mesh=
...)`` are the ``mesh=None`` steps bit for bit, with K2 launched in every
prefill layer and K3 in every RWKV prefill layer (and twice a training
layer: its forward and remat's recompute) on the DTensor path;
FACADE's smoke step on ``make_debug_mesh((1, 1, 1), ("pod", "data",
"model"))`` is the ``mesh=None`` step bit for bit, with K1 once (step 2c
through its DTensor branch) and K2 in both nodes' feature passes;
a shard of the head dim is refused by the kernels' DTensor branch. On
one rank ``localmap.grad_in_layout`` adds no node, so these train steps
do not run its ``_InLayout`` (the four-rank gloo world of
``tests/test_torch_lm_mesh.py`` does).

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX.
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv6 import wkv
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.base import get_config
from repro_torch.tree import tree_leaves
from torch_caps import cuda_device, requires_cuda  # noqa: F401

CASES = [("llama3.2-1b", "prefill_32k", (2, 0)),
         ("llama3.2-1b", "decode_32k", (0, 0)),
         ("llama3.2-1b", "train_4k", (0, 0)),
         ("rwkv6-1.6b", "prefill_32k", (0, 2)),
         ("rwkv6-1.6b", "train_4k", (0, 4))]   # forward and remat


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The one-rank group the first mesh starts, taken down after the
    module."""
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def mesh(cuda_device):
    return make_debug_mesh((1, 1), ("data", "model"))


def _leaves(out) -> list:
    from torch.distributed.tensor import DTensor
    got = []
    for part in out:
        for x in (tree_leaves(part) if isinstance(part, dict) else [part]):
            if isinstance(x, DTensor):
                x = x.full_tensor()
            if isinstance(x, torch.Tensor):
                got.append(x)
    return got


@requires_cuda
@pytest.mark.parametrize("arch, shape, launches", CASES)
def test_mesh_1x1_is_mesh_none_bit_for_bit(mesh, arch, shape, launches):
    cfg = get_config(arch, smoke=True)
    kw = dict(batch=2, seq=64, cfg=cfg, seed=0, device="cuda")
    plain = steps.build_case(arch, shape, **kw)
    want = _leaves(plain.step_fn(*plain.args))
    case = steps.build_case(arch, shape, mesh=mesh, **kw)
    fa0, wkv0 = flash_attention.launches, wkv.launches
    got = _leaves(case.step_fn(*case.args))
    torch.cuda.synchronize()
    assert (flash_attention.launches - fa0, wkv.launches - wkv0) == \
        launches
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@requires_cuda
def test_facade_on_a_pod_mesh_1x1x1_is_mesh_none_bit_for_bit(cuda_device):
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.head_select import head_losses

    pod = make_debug_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = get_config("llama3.2-1b", smoke=True)
    kw = dict(batch_per_node=2, seq=64, cfg=cfg, seed=0, device="cuda")
    plain = steps.build_facade_case("llama3.2-1b", **kw)
    state, info = plain.step_fn(*plain.args)
    want = _leaves([state.cores, state.heads, state.cluster_id,
                    info["selection_losses"]])
    case = steps.build_facade_case("llama3.2-1b", mesh=pod, **kw)
    k1, fa0 = head_losses.launches, flash_attention.launches
    state, info = case.step_fn(*case.args)
    torch.cuda.synchronize()
    assert (head_losses.launches - k1, flash_attention.launches - fa0) == \
        (1, 2 * cfg.n_layers)
    assert isinstance(info["selection_losses"], DTensor)
    got = _leaves([state.cores, state.heads, state.cluster_id,
                   info["selection_losses"]])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@requires_cuda
def test_kernel_refuses_a_shard_of_the_head_dim(mesh):
    from torch.distributed.tensor import DTensor, Shard
    q = torch.randn(1, 32, 2, 64, device="cuda")
    qd = DTensor.from_local(q, mesh, [Shard(0), Shard(3)], run_check=False)
    with pytest.raises(ValueError, match="placement"):
        with torch.no_grad():
            flash_attention(qd, qd, qd)
