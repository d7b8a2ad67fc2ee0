"""The kernels without a backward refuse to run under autograd on the
card, and attention that needs a gradient goes through the differentiable
plain ``sdpa``.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. Tolerance of the card against the CPU:
1e-4 absolute and relative on the output and on every gradient (fp32 on
both, TF32 off; the matmuls and softmax sum in other orders).
"""
from __future__ import annotations

import pytest
import torch

import repro_torch.configs  # noqa: F401  (registry)
from repro_torch.device import no_tf32
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv6 import wkv
from repro_torch.models import attention
from repro_torch.models.base import get_config
from torch_caps import cuda_device, requires_cuda  # noqa: F401

TOL = 1e-4


@requires_cuda
def test_flash_attention_raises_under_grad(cuda_device):
    q, k, v = (0.3 * torch.randn((1, 64, h, 64), device=cuda_device)
               for h in (4, 2, 2))
    with torch.no_grad():
        flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    flash_attention(q.detach(), k, v)          # nothing needs a gradient


@requires_cuda
def test_wkv_raises_under_grad(cuda_device):
    r, k, v = (0.3 * torch.randn((1, 32, 2, 64), device=cuda_device)
               for _ in range(3))
    w = torch.full((1, 32, 2, 64), 0.9, device=cuda_device)
    u = torch.zeros((2, 64), device=cuda_device, requires_grad=True)
    with torch.no_grad():
        wkv(r, k, v, w, u)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv(r, k, v, w, u)


@requires_cuda
def test_gqa_forward_trains_on_the_card_as_on_the_cpu(cuda_device):
    cfg = get_config("llama3.2-1b", smoke=True)           # fp32
    g = torch.Generator().manual_seed(0)
    p = attention.init_gqa(g, cfg)
    x = torch.randn((2, 96, cfg.d_model), generator=g)
    pos = torch.arange(96, dtype=torch.int32)[None].expand(2, 96)

    def run(device):
        leaves = {"x": x.to(device).requires_grad_(),
                  **{k: w.to(device).requires_grad_() for k, w in p.items()}}
        params = {k: leaves[k] for k in p}
        before = flash_attention.launches
        with no_tf32():
            out = attention.gqa_forward(cfg, params, leaves["x"],
                                        pos.to(device))
            out.square().sum().backward()
        assert flash_attention.launches == before   # the plain sdpa
        return out.detach().cpu(), {k: t.grad.cpu()
                                    for k, t in leaves.items()}

    out, grads = run(cuda_device)
    want, want_grads = run(torch.device("cpu"))
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
    for name in ("x", "wq", "wk", "wv", "wo"):
        assert bool(torch.isfinite(grads[name]).all()), name
        assert float(grads[name].abs().max()) > 0, name
        torch.testing.assert_close(grads[name], want_grads[name], rtol=TOL,
                                   atol=TOL)
