"""The RWKV6 wkv CUDA kernel against its plain version, on the card.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. Tolerance 1e-5 absolute and relative on
y and on the final state, the reference kernel tests' (fp32 on both sides,
other summation order)."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.rwkv6 import wkv, wkv_scan
from torch_caps import cuda_device, requires_cuda  # noqa: F401

# (B, S, H, hd): the reference kernel tests' RW_SHAPES, ragged sequences
# and one step
SHAPES = [(1, 64, 1, 32), (2, 128, 2, 32), (1, 256, 4, 64), (2, 100, 3, 64),
          (1, 1, 2, 64), (3, 37, 2, 32)]
TOL = 1e-5


def _case(b, s, h, hd, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (0.3 * torch.randn((3, b, s, h, hd), generator=g)).unbind(0)
    w = torch.exp(-torch.exp(0.3 * torch.randn((b, s, h, hd), generator=g)))
    u = 0.3 * torch.randn((h, hd), generator=g)
    return [x.contiguous().to(device) for x in (r, k, v, w, u)]


@requires_cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain_version(cuda_device, shape):
    args = _case(*shape, cuda_device)
    before = wkv.launches
    y, s = wkv(*args)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    y_ref, s_ref = wkv_scan(*args)
    torch.testing.assert_close(y, y_ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s, s_ref, rtol=TOL, atol=TOL)


@requires_cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    r, k, v, w, u = _case(1, 8, 2, 64, cuda_device)
    with pytest.raises(TypeError):
        wkv(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="head dim"):
        wkv(*_case(1, 8, 2, 16, cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        wkv(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError, match="devices"):
        wkv(r.cpu(), k, v, w, u)
