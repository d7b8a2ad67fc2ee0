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
# and one step; then the kernel's chunks of 16 steps: S around a chunk
# boundary and within one, and B * H = 264 blocks, two waves of the 132 SMs
SHAPES = [(1, 64, 1, 32), (2, 128, 2, 32), (1, 256, 4, 64), (2, 100, 3, 64),
          (1, 1, 2, 64), (3, 37, 2, 32),
          (1, 1, 2, 32), (2, 31, 2, 64), (2, 33, 2, 64), (1, 15, 3, 32),
          (6, 48, 44, 64), (3, 40, 88, 32)]
# log decay shifts: w near 0 (exp(-e^2), about 6e-4) and near 1
# (exp(-e^-6), about 0.9975)
DECAYS = {"strong": 2.0, "weak": -6.0}
TOL = 1e-5


def _case(b, s, h, hd, device, seed=0, log_decay=0.0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (0.3 * torch.randn((3, b, s, h, hd), generator=g)).unbind(0)
    w = torch.exp(-torch.exp(log_decay + 0.3 * torch.randn((b, s, h, hd),
                                                           generator=g)))
    u = 0.3 * torch.randn((h, hd), generator=g)
    return [x.contiguous().to(device) for x in (r, k, v, w, u)]


@requires_cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain_version(cuda_device, shape):
    _check(_case(*shape, cuda_device))


@requires_cuda
@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("shape", [(2, 100, 3, 64), (1, 512, 2, 32)],
                         ids=str)
def test_kernel_under_strong_and_weak_decay(cuda_device, shape, decay):
    _check(_case(*shape, cuda_device, log_decay=DECAYS[decay]))


def _check(args):
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
    shifted = torch.empty(r.numel() + 1, device=r.device)[1:].view(r.shape)
    with pytest.raises(ValueError, match="aligned"):
        wkv(shifted, k, v, w, u)
