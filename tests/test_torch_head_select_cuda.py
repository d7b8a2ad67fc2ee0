"""The head-select CUDA kernel against its plain version, on the card.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX, so it also runs where only PyTorch is
installed. Tolerance: 2e-5 absolute and relative — kernel and plain
version read the same values and both accumulate in fp32, so they differ
only in summation order. Argmin must agree exactly. The kernel has four
bodies (``ops.body_for``): bf16 with D and V multiples of 8, or with V of
at least 256 (a ragged D or V copied into padded rows first), takes the
tensor-core body; fp32 with V of at least 128 the fp32 tensor-core body
(3xTF32) from D 192 up and the fp32 tiled body below; every other input
the FMA body. So in bf16 the tensor-core body runs the first
three SHAPES, EDGE_SHAPES' (2, 2, 8, 32, 16), (3, 1, 3, 33, 1024) (D
padded) and (2, 3, 1, 64, 24) (one 128 × 256 tile, mostly masked), every
LM_SHAPES case and every PADDED_SHAPES case; the FMA body runs bf16 at the
other SHAPES and EDGE_SHAPES (D 1, 31, 65, 70 or 513 with V under 256, or
V 1, 10, 17, 41 or 45) and in the bf16 identical-heads case. fp32 runs the
tiled body at the first three SHAPES, EDGE_SHAPES' (3, 1, 3, 33, 1024) and
every F32_SHAPES case but the last, which takes the fp32 tensor-core body
(D 2048), and the FMA body at the CNN shapes (V 10 and 41) and the other
EDGE_SHAPES. The fp32 tensor-core body is also forced at every
TC32_SHAPES case, against a float64 witness too.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.head_select import head_losses, head_losses_ref
from torch_caps import (chip_smoke_constant, cuda_device,  # noqa: F401
                        requires_cuda)

# (n, K, T, D, V): the reference kernel tests' HS_SHAPES with one node, the
# main path's shape (32 nodes, 2 heads, B = 8, LeNet's 512 + bias, 10), and
# ResNet8's step 2c at paper scale (one stream per (node, head): 32 · 2, B
# 8, block3's 64 + bias, 41 classes)
SHAPES = [(1, 2, 128, 64, 256), (1, 3, 256, 64, 512), (1, 5, 128, 128, 1024),
          (32, 2, 8, 513, 10), (3, 4, 37, 70, 45), (64, 1, 8, 65, 41)]
# the edges of the kernel's design: D around its 32 lanes (1, 31, 32, 33,
# 513), V around its 16-column chunks (1, 10, 16, 17, 1024), T = 1, and n·K
# odd, so every other head block starts off 16-byte alignment; T = 1 in
# the tensor-core body's reach (D 64, V 24). In these cases the last
# node's labels are all excluded, which must give 0.0.
EDGE_SHAPES = [(3, 1, 1, 1, 1), (3, 3, 9, 31, 17), (2, 2, 8, 32, 16),
               (3, 3, 5, 33, 10), (3, 1, 3, 33, 1024), (7, 1, 8, 513, 10),
               (3, 3, 1, 513, 17), (2, 3, 1, 64, 24)]
# the LM regime, bf16 only (the FMA body would take tens of seconds a call
# there): step 2c of FACADE on llama3.2-1b (n·K 4, T = B·S 1024, D 2048,
# V 128,256), T off the token tiles with V = 1000 (3.9 of the 256-column
# tiles) and with rwkv6-1.6b's V = 65,536; then the body's edges: D off its
# 64-row stages (72, 32), and V's last tile within its first 64 columns
# (136; and 8); then n·K odd with T around the 128-token tiles (1, 127,
# 128, 129), D 8, 64 and 72 (the 16-row wgmma steps and the 64-row
# stages) and V around the 256-column tiles (8, 248, 256, 264, 1032), V 264
# and 1032 in more than one V-split. The last node's labels are all
# excluded, which must give 0.0.
LM_SHAPES = [(4, 1, 1024, 2048, 128256), (2, 2, 1000, 2048, 1000),
             (4, 1, 200, 2048, 65536), (3, 1, 300, 72, 136),
             (2, 2, 4096, 32, 8), (3, 1, 1, 8, 8), (3, 1, 127, 64, 248),
             (3, 3, 128, 72, 256), (5, 1, 129, 64, 264),
             (3, 3, 129, 8, 1032)]
# the fp32 tiled body's edges (fp32 only): T around its 128-token tiles
# (1, 127, 129), D around its 16-row chunks and off its 16-byte copies (16,
# 17, 33, 5), V around its 128-column tiles (128, 129, 255, 383) and in
# several V-splits, n·K odd; then a four-card FACADE rank's step 2c (n·K
# 2, T 512, D 2048, V 128,256). The last node's labels are all excluded.
F32_SHAPES = [(1, 2, 1, 16, 128), (3, 1, 127, 17, 129),
              (3, 3, 129, 33, 255), (2, 2, 200, 5, 383),
              (5, 1, 130, 64, 1000), (2, 1, 512, 2048, 128256)]
# the tensor-core body on a ragged V or D (bf16 only): V 249, 257, 1001 and
# 4,099 (one to 17 vocab tiles, the last ragged), D 36, 70 and 2,044 (off
# the 8-value rows); hymba-1.5b's LM FACADE step 2c (V 32,001) and
# whisper-tiny's vocabulary (V 51,865). The last node's labels are all
# excluded.
PADDED_SHAPES = [(1, 2, 130, 64, 249), (3, 1, 129, 36, 1001),
                 (3, 1, 64, 24, 257), (2, 2, 127, 70, 1001),
                 (2, 1, 300, 2044, 4099), (4, 1, 1024, 1600, 32001),
                 (2, 1, 256, 384, 51865)]
CASES = [(dt, shape) for dt in (torch.float32, torch.bfloat16)
         for shape in SHAPES + EDGE_SHAPES] + \
    [(torch.bfloat16, shape) for shape in LM_SHAPES] + \
    [(torch.float32, shape) for shape in F32_SHAPES] + \
    [(torch.bfloat16, shape) for shape in PADDED_SHAPES]
DTYPE_IDS = {torch.float32: "fp32", torch.bfloat16: "bf16"}
TOL = 2e-5


def _case(n, k, t, d, v, dtype, device, seed=0, draw_on=None):
    """Features 0.5 randn, heads 0.05 randn, ~10% of labels excluded;
    drawn on the CPU (or on ``draw_on``, for the LM regime's GBs)."""
    g = torch.Generator(draw_on or "cpu").manual_seed(seed)
    dev = g.device
    feats = (0.5 * torch.randn((n, t, d), generator=g, device=dev)).to(dtype)
    heads = (0.05 * torch.randn((n, k, d, v), generator=g,
                                device=dev)).to(dtype)
    labels = torch.randint(0, v, (n, t), generator=g, dtype=torch.int32,
                           device=dev)
    labels[torch.rand((n, t), generator=g, device=dev) < 0.1] = -1
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
@pytest.mark.parametrize("dtype,shape", CASES,
                         ids=[f"{DTYPE_IDS[dt]}-{shape}"
                              for dt, shape in CASES])
def test_kernel_matches_plain_version(cuda_device, shape, dtype):
    lm = shape in LM_SHAPES + F32_SHAPES + PADDED_SHAPES
    feats, heads, labels = _case(*shape, dtype, cuda_device,
                                 draw_on=cuda_device if lm else None)
    if shape in EDGE_SHAPES or lm:
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
    if shape in EDGE_SHAPES or lm:
        assert torch.equal(got[-1], torch.zeros_like(got[-1]))


@requires_cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (32, 1, 8, 513, 10)),
    (torch.bfloat16, (32, 1, 8, 513, 10)),
    (torch.bfloat16, (2, 1, 1024, 2048, 128256)),
    (torch.bfloat16, (3, 1, 129, 72, 1032)),
    (torch.float32, (2, 1, 1024, 2048, 128256)),
    (torch.float32, (3, 1, 129, 17, 383)),
    (torch.bfloat16, (2, 1, 1024, 1600, 32001)),
    (torch.bfloat16, (3, 1, 129, 70, 1001)),
], ids=["fp32", "bf16", "bf16-lm", "bf16-lm-edge", "fp32-lm", "fp32-edge",
        "bf16-padded", "bf16-padded-edge"])
def test_identical_heads_give_bit_identical_losses(cuda_device, dtype,
                                                   shape):
    lm = shape[-1] > 300
    feats, heads, labels = _case(*shape, dtype, cuda_device,
                                 draw_on=cuda_device if lm else None)
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
    # the LM regime's 16-byte copies: features off 16-byte alignment
    feats, heads, labels = _case(1, 1, 256, 64, 256, torch.bfloat16,
                                 cuda_device)
    shifted = torch.empty(feats.numel() + 1, dtype=feats.dtype,
                          device=cuda_device)[1:].view(feats.shape)
    shifted.copy_(feats)
    with pytest.raises(RuntimeError, match="misaligned"):
        head_losses(shifted, heads, labels)
    # and heads off 16-byte alignment
    shifted = torch.empty(heads.numel() + 1, dtype=heads.dtype,
                          device=cuda_device)[1:].view(heads.shape)
    shifted.copy_(heads)
    with pytest.raises(RuntimeError, match="misaligned"):
        head_losses(feats, shifted, labels)


@requires_cuda
@pytest.mark.parametrize("dtype,shape,body", [
    (torch.float32, (1, 5, 128, 128, 1024), "fma"),
    (torch.float32, (2, 2, 130, 33, 300), "fma"),
    (torch.float32, (4, 2, 8, 513, 10), "fp32_tiled"),
    (torch.float32, (2, 1, 512, 2048, 128256), "fp32_tiled"),
    (torch.float32, (4, 2, 8, 513, 10), "fp32_tensor_core"),
    (torch.bfloat16, (2, 2, 130, 36, 300), "fma"),
    (torch.bfloat16, (4, 2, 8, 513, 10), "tensor_core"),
], ids=["fp32-hs2-fma", "fp32-ragged-fma", "fp32-cnn-tiled",
        "fp32-lm-tiled", "fp32-cnn-tc32", "bf16-ragged-fma", "bf16-cnn-tc"])
def test_a_forced_body_matches_plain_version(cuda_device, dtype, shape,
                                             body):
    """Each body on inputs the rule gives another (the timings' forced
    calls): the same function within the tolerance."""
    feats, heads, labels = _case(*shape, dtype, cuda_device, seed=3,
                                 draw_on=cuda_device if shape[-1] > 1000
                                 else None)
    got = head_losses(feats, heads, labels, body=body)
    torch.cuda.synchronize()
    want = head_losses_ref(feats, heads, labels)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL, atol=TOL)
    assert torch.equal(got.argmin(1), want.argmin(1))
    with pytest.raises(ValueError, match="does not take"):
        head_losses(feats, heads, labels,
                    body="tensor_core" if dtype == torch.float32
                    else "fp32_tiled")


@requires_cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (2, 2, 130, 64, 300)),
    (torch.bfloat16, (2, 2, 130, 64, 249)),
], ids=["fp32-4-byte-copies", "bf16-padded"])
def test_wider_paths_take_inputs_off_16_byte_alignment(cuda_device, dtype,
                                                       shape):
    """Features and heads one element off 16-byte alignment: the fp32 body
    falls back to 4-byte copies, and the padded copy of a ragged V reads any
    address (the features stay aligned: D 64 is copied by no one)."""
    feats, heads, labels = _case(*shape, dtype, cuda_device, seed=4)
    if dtype == torch.float32:
        shifted = torch.empty(feats.numel() + 1, dtype=dtype,
                              device=cuda_device)[1:].view(feats.shape)
        shifted.copy_(feats)
        feats = shifted
    shifted = torch.empty(heads.numel() + 1, dtype=dtype,
                          device=cuda_device)[1:].view(heads.shape)
    shifted.copy_(heads)
    got = head_losses(feats, shifted, labels)
    torch.cuda.synchronize()
    want = head_losses_ref(feats, shifted, labels)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL, atol=TOL)
    assert torch.equal(got.argmin(1), want.argmin(1))


# the fp32 tensor-core body (3xTF32) forced, at every fp32 shape above
# whichever body the rule gives it: T around its 128-token tiles (1, 127,
# 129, 130, 200), D around its 8-deep k-steps, the feature planes' 4-value
# rows and its 32-row stages (5, 16, 17, 33, 64, 70, 2048), V around its
# 128-column tiles and 64-column consumers (128, 129, 255, 300, 383 and
# 1000: the heads copied into rows of V rounded up to 4 where V is not a
# multiple of 4), the reference tests' shapes and a four-card FACADE
# rank's step 2c. The last node's labels are all excluded.
TC32_SHAPES = SHAPES[:3] + F32_SHAPES + [(3, 2, 40, 70, 300),
                                         (4, 2, 256, 2048, 4096)]
# its gate against a float64 witness (chip_smoke.HS_TC32_FACTOR and
# HS_TC32_FLOOR): the distance within the factor times the plain fp32
# version's, or the floor
TC32_FACTOR = chip_smoke_constant("HS_TC32_FACTOR")
TC32_FLOOR = chip_smoke_constant("HS_TC32_FLOOR")


def _witness(feats, heads, labels):
    """The plain version's steps in float64 on the same inputs."""
    n, k = heads.shape[:2]
    t = feats.shape[1]
    logits = torch.einsum("ntd,nkdv->nktv", feats.double(), heads.double())
    lse = torch.logsumexp(logits, dim=-1)
    labs = labels.long().clamp(min=0)[:, None, :, None].expand(n, k, t, 1)
    gold = torch.gather(logits, -1, labs).squeeze(-1)
    valid = (labels >= 0)[:, None, :]
    nll = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return nll.sum(-1) / valid.sum(-1).clamp(min=1)


@requires_cuda
@pytest.mark.parametrize("shape", TC32_SHAPES, ids=str)
def test_fp32_tensor_core_body_matches_plain_version(cuda_device, shape):
    """Against the plain version (``TOL``, equal argmins, 0.0 where every
    label is excluded) and the float64 witness; two calls give the same
    bits and bit-identical heads bit-identical losses."""
    feats, heads, labels = _case(*shape, torch.float32, cuda_device,
                                 draw_on=cuda_device)
    labels[-1] = -1
    before = head_losses.launches
    got = head_losses(feats, heads, labels, body="fp32_tensor_core")
    torch.cuda.synchronize()
    assert head_losses.launches == before + 1
    want = head_losses_ref(feats, heads, labels)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL, atol=TOL)
    assert torch.equal(got.argmin(1), want.argmin(1))
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    witness = _witness(feats, heads, labels)

    def dist(x):
        return float(((x.double() - witness).abs()
                      / witness.abs().clamp(min=1)).max())
    assert dist(got) <= max(TC32_FACTOR * dist(want), TC32_FLOOR)
    assert torch.equal(got, head_losses(feats, heads, labels,
                                        body="fp32_tensor_core"))
    same = head_losses(feats, heads[:, :1].repeat(1, 2, 1, 1).contiguous(),
                       labels, body="fp32_tensor_core")
    assert torch.equal(same[:, 0], same[:, 1])


@requires_cuda
@pytest.mark.parametrize("v", [4096, 4099])
def test_fp32_tensor_core_body_on_non_finite_inputs(cuda_device, v):
    """NaN features, NaN heads, a +inf weight on a feature of 1 (exact in
    TF32: a +inf logit, a +inf loss, not inf 0 = NaN) and a head of +inf
    weights (NaN logits): NaN and +inf at the plain version's places, the
    finite losses within ``TOL``, the argmins equal; V 4099 through the
    copy into rows of V rounded up to 4."""
    feats, heads, labels = _case(4, 2, 256, 2048, v, torch.float32,
                                 cuda_device, seed=6, draw_on=cuda_device)
    labels[0, 3] = 5
    feats[0, 3] = float("nan")
    heads[1, 1] = float("nan")
    feats[2, :, 0] = 1.0
    free = sorted(set(range(v)) - set(labels[2].tolist()))[0]
    heads[2, 0, 0, free] = float("inf")
    heads[3, 1] = float("inf")
    got = head_losses(feats, heads, labels, body="fp32_tensor_core")
    want = head_losses_ref(feats, heads, labels)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isposinf(), want.isposinf())
    assert bool(got[2, 0].isposinf())
    fin = torch.isfinite(want)
    np.testing.assert_allclose(got[fin].cpu().numpy(),
                               want[fin].cpu().numpy(), rtol=TOL, atol=TOL)
    assert torch.equal(got.argmin(1), want.argmin(1))


@requires_cuda
def test_fp32_tensor_core_body_alignment(cuda_device):
    """Heads off 16-byte alignment: refused where V is a multiple of 4
    (TMA reads them in place), taken through the copy into padded rows
    where it is not; features at any address (split into the workspace)."""
    for v, refused in ((300, True), (301, False)):
        feats, heads, labels = _case(2, 2, 130, 64, v, torch.float32,
                                     cuda_device, seed=4)
        shifted = []
        for x in (feats, heads):
            y = torch.empty(x.numel() + 1, dtype=x.dtype,
                            device=cuda_device)[1:].view(x.shape)
            y.copy_(x)
            shifted.append(y)
        if refused:
            with pytest.raises(RuntimeError, match="misaligned"):
                head_losses(shifted[0], shifted[1], labels,
                            body="fp32_tensor_core")
            continue
        got = head_losses(*shifted, labels, body="fp32_tensor_core")
        want = head_losses_ref(feats, heads, labels)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=TOL, atol=TOL)
