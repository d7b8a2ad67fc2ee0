"""The head-select CUDA kernel against its plain version, on the card.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX, so it also runs where only PyTorch is
installed. Tolerance: 2e-5 absolute and relative — kernel and plain
version read the same values and both accumulate in fp32, so they differ
only in summation order. Argmin must agree exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.head_select import head_losses, head_losses_ref
from torch_caps import cuda_device, requires_cuda  # noqa: F401

# (n, K, T, D, V): the reference kernel tests' HS_SHAPES with one node, and
# the main path's shape (32 nodes, 2 heads, B = 8, LeNet's 512 + bias, 10)
SHAPES = [(1, 2, 128, 64, 256), (1, 3, 256, 64, 512), (1, 5, 128, 128, 1024),
          (32, 2, 8, 513, 10), (3, 4, 37, 70, 45)]
# the edges of the kernel's design: D around its 32 lanes (1, 31, 32, 33,
# 513), V around its 16-column chunks (1, 10, 16, 17, 1024), T = 1, and n·K
# odd, so every other head block starts off 16-byte alignment. In these
# cases the last node's labels are all excluded, which must give 0.0.
EDGE_SHAPES = [(3, 1, 1, 1, 1), (3, 3, 9, 31, 17), (2, 2, 8, 32, 16),
               (3, 3, 5, 33, 10), (3, 1, 3, 33, 1024), (7, 1, 8, 513, 10),
               (3, 3, 1, 513, 17)]
TOL = 2e-5


def _case(n, k, t, d, v, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = (0.5 * torch.randn((n, t, d), generator=g)).to(dtype)
    heads = (0.05 * torch.randn((n, k, d, v), generator=g)).to(dtype)
    labels = torch.randint(0, v, (n, t), generator=g, dtype=torch.int32)
    labels[torch.rand((n, t), generator=g) < 0.1] = -1
    return feats.to(device), heads.to(device), labels.to(device)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


@requires_cuda
@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_matches_plain_version(cuda_device, shape, dtype):
    feats, heads, labels = _case(*shape, dtype, cuda_device)
    if shape in EDGE_SHAPES:
        labels[-1] = -1
    before = head_losses.launches
    got = head_losses(feats, heads, labels)
    torch.cuda.synchronize()
    assert head_losses.launches == before + 1
    want = head_losses_ref(feats, heads, labels)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL, atol=TOL)
    assert torch.equal(got.argmin(1), want.argmin(1))
    if shape in EDGE_SHAPES:
        assert torch.equal(got[-1], torch.zeros_like(got[-1]))


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_identical_heads_give_bit_identical_losses(cuda_device, dtype):
    feats, heads, labels = _case(32, 1, 8, 513, 10, dtype, cuda_device)
    got = head_losses(feats, heads.repeat(1, 2, 1, 1).contiguous(), labels)
    assert torch.equal(got[:, 0], got[:, 1])
    assert int(got.argmin(1).max()) == 0


@requires_cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    feats, heads, labels = _case(2, 2, 8, 16, 5, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        head_losses(feats.half(), heads.half(), labels)
    with pytest.raises(TypeError):
        head_losses(feats, heads, labels.long())
    with pytest.raises(ValueError, match="contiguous"):
        head_losses(feats.transpose(1, 2).contiguous().transpose(1, 2),
                    heads, labels)
    with pytest.raises(ValueError, match="devices"):
        head_losses(feats.cpu(), heads, labels)
