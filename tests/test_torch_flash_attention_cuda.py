"""The flash-attention CUDA kernel against its plain version, on the card.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX, so it also runs where only PyTorch is
installed. The plain version runs in fp32 on the same values. fp32 output
is held to it at 2e-6, the reference kernel tests' tolerance (fp32
softmax and accumulation on both sides); bf16 output, whose scores,
softmax and accumulator the kernel keeps in fp32 (P V with P as three bf16
terms) and rounds once, within one bf16 ulp of the answer (relative 2^-8,
plus 1e-6)."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from torch_caps import cuda_device, requires_cuda  # noqa: F401

# (B, Hq, Hkv, S, D): the reference kernel tests' FA_SHAPES, a ragged S, a
# narrow head (the smoke config's), a wide one with a window and
# stablelm-12b's head dim 160 at a ragged S
SHAPES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128),
          (2, 2, 2, 512, 64), (1, 4, 2, 200, 64), (2, 8, 2, 77, 32),
          (1, 4, 2, 300, 128), (2, 8, 2, 130, 160)]
# llama3.2-1b's serving shape, a long one and stablelm-12b's serving shape
SERVING_SHAPES = [(4, 32, 8, 512, 64), (1, 32, 8, 4096, 64),
                  (4, 32, 8, 512, 160)]
# the hybrid, audio and VLM families' prefill shapes, (B, Hq, Hkv, S, D),
# causal, window: hymba-1.5b past its window of 1024 (GQA group 5),
# whisper-tiny's encoder (non-causal, S 1500 ragged against the 64-row
# tiles) and its smoke encoder, llava-next-34b's 2880 image positions and
# 512-token prompt (GQA group 7)
FAMILY_CASES = [((4, 25, 5, 2048, 64), True, 1024),
                ((4, 6, 6, 1500, 64), False, 0),
                ((2, 4, 4, 32, 32), False, 0),
                ((4, 56, 8, 3392, 128), True, 0)]
TOLS = {torch.float32: dict(atol=2e-6, rtol=2e-6),
        torch.bfloat16: dict(atol=1e-6, rtol=2.0 ** -8)}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


# bf16 cases of the tensor-core kernel's own paths: (B, Hq, Hkv, S, D),
# causal, window, std of q and k. Non-causal at each D; ragged S against
# its 64-row tiles (1, 65, 127); large scores (q and k at 3 randn, scores
# of tens) that exercise the running-max rescaling
BF16_CASES = [((1, 4, 2, 130, 32), False, 0, 0.3),
              ((1, 4, 2, 130, 64), False, 0, 0.3),
              ((1, 4, 2, 130, 128), False, 0, 0.3),
              ((1, 4, 2, 130, 64), False, 32, 0.3),
              ((1, 2, 1, 1, 64), True, 0, 0.3),
              ((2, 4, 2, 65, 64), True, 0, 0.3),
              ((1, 4, 4, 127, 128), True, 32, 0.3),
              ((2, 8, 2, 256, 64), True, 0, 3.0),
              ((1, 4, 2, 200, 128), True, 128, 3.0),
              ((1, 4, 2, 130, 160), False, 0, 0.3),
              ((1, 2, 1, 1, 160), True, 0, 0.3),
              ((2, 8, 2, 256, 160), True, 0, 3.0)]


def _case(b, hq, hkv, s, d, dtype, device, seed=0, qk_std=0.3):
    g = torch.Generator().manual_seed(seed)
    return [(std * torch.randn((b, s, h, d), generator=g)).to(dtype).to(
        device) for h, std in ((hq, qk_std), (hkv, qk_std), (hkv, 0.3))]


def _plain(q, k, v, **kw):
    t = [x.transpose(1, 2) for x in (q, k, v)]
    return attention_ref(*t, **kw).transpose(1, 2)


@requires_cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [0, 32, 128])
def test_kernel_matches_plain_version(cuda_device, shape, dtype, window):
    _check(shape, dtype, window, cuda_device)


@requires_cuda
@pytest.mark.parametrize("shape", SERVING_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_matches_plain_version_at_serving_shapes(cuda_device, shape,
                                                        dtype):
    _check(shape, dtype, 0, cuda_device)


@requires_cuda
@pytest.mark.parametrize("case", FAMILY_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_matches_plain_version_at_the_new_families_shapes(
        cuda_device, case, dtype):
    shape, causal, window = case
    _check(shape, dtype, window, cuda_device, causal=causal)


@requires_cuda
@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_bf16_kernel_paths(cuda_device, case):
    shape, causal, window, qk_std = case
    _check(shape, torch.bfloat16, window, cuda_device, causal=causal,
           qk_std=qk_std)


def _check(shape, dtype, window, device, causal=True, qk_std=0.3):
    q, k, v = _case(*shape, dtype, device, qk_std=qk_std)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = _plain(q.float(), k.float(), v.float(), causal=causal,
                  window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, **TOLS[dtype])


@requires_cuda
@pytest.mark.parametrize("dims", [(48, 32), (96, 64)], ids=["smoke", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_mla_padded_call_matches_sdpa(cuda_device, dims, dtype):
    """MLA's q.k and v head dims (minicpm3-4b's smoke and full config)
    through ``attention.mla_attention``: one launch at the padded head
    dim, against the plain ``sdpa`` on the unpadded tensors in fp32."""
    from repro_torch.models import attention
    dq, dv = dims
    b, s, h = 2, 200, 5
    g = torch.Generator().manual_seed(dq)
    q, k = (0.3 * torch.randn((b, s, h, dq), generator=g) for _ in "qk")
    v = 0.3 * torch.randn((b, s, h, dv), generator=g)
    q, k, v = (x.to(dtype).to(cuda_device) for x in (q, k, v))
    before = flash_attention.launches
    got = attention.mla_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    pos = torch.arange(s, device=cuda_device)[None].expand(b, s)
    want = attention.sdpa(q.float(), k.float(), v.float(), pos, pos)
    assert got.dtype == dtype and got.shape == (b, s, h, dv)
    torch.testing.assert_close(got.float(), want, **TOLS[dtype])


@requires_cuda
def test_non_causal(cuda_device):
    q, k, v = _case(1, 4, 2, 130, 64, torch.float32, cuda_device)
    got = flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got, _plain(q, k, v, causal=False),
                               rtol=2e-6, atol=2e-6)


@requires_cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _case(1, 4, 2, 64, 64, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*_case(1, 4, 2, 64, 48, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="devices"):
        flash_attention(q.cpu(), k, v)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=q.device)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(shifted, k, v)
