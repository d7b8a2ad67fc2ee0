"""The kernels without a backward refuse to run under autograd on the
card, attention that needs a gradient goes through the differentiable
plain ``sdpa``, and the wkv recurrence trains through ``wkv_train`` (K3
forward, K3's backward kernel).

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. Tolerance of the card against the CPU:
1e-4 absolute and relative on the output and on every gradient (fp32 on
both, TF32 off; the matmuls and softmax sum in other orders).
``wkv_train`` against the plain ``wkv_scan`` on the card: y and the
final state 1e-5 (K3's tolerance); the gradients, one backward launch,
against a float64 witness (the plain loop in float64 on the same
inputs), each leaf relative to its largest |gradient|: within
``BWD_FACTOR`` times the plain fp32 loop's own distance from the witness
(or ``BWD_FLOOR``, a few fp32 ulps of the largest, where that distance is
near 0), and within 1e-5 (chip_smoke.py's gate; the largest ratio read
on the card was 2.32). RWKV's
``time_mix`` on the card against the CPU: the output 1e-4 as above, each
gradient within 1e-4 of its leaf's largest gradient (as the round tests
hold parameters): its gradients span three orders of magnitude within a
leaf, and the CPU's own fp32 gradients differ from float64 by up to
3e-6 of a leaf's largest, so an elementwise relative bound on the
smallest elements would measure their rounding alone.
"""
from __future__ import annotations

import pytest
import torch

import repro_torch.configs  # noqa: F401  (registry)
from repro_torch.device import no_tf32
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv6 import wkv, wkv_backward, wkv_scan, wkv_train
from repro_torch.models import attention, rwkv
from repro_torch.models.base import get_config
from torch_caps import cuda_device, requires_cuda  # noqa: F401

TOL = 1e-4
BWD_FACTOR, BWD_FLOOR, BWD_TOL = 4.0, 2.0 ** -21, 1e-5


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


def _wkv_inputs(device, b=2, s=100, h=3, hd=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (0.3 * torch.randn((3, b, s, h, hd), generator=g)).unbind(0)
    w = torch.exp(-torch.exp(0.3 * torch.randn((b, s, h, hd), generator=g)))
    u = 0.3 * torch.randn((h, hd), generator=g)
    return [x.contiguous().to(device).requires_grad_()
            for x in (r, k, v, w, u)]


@requires_cuda
@pytest.mark.parametrize("s", [1, 33, 256])
def test_wkv_train_runs_k3_forward_and_its_backward_kernel(cuda_device, s):
    got_in = _wkv_inputs(cuda_device, s=s, seed=s)
    want_in = [x.detach().clone().requires_grad_() for x in got_in]
    wide_in = [x.detach().double().requires_grad_() for x in got_in]
    before, before_bwd = wkv.launches, wkv_backward.launches
    y, s_final = wkv_train(*got_in)
    assert wkv.launches == before + 1
    y_ref, s_ref = wkv_scan(*want_in)
    y_wide, s_wide = wkv_scan(*wide_in)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_final, s_ref, rtol=1e-5, atol=1e-5)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    seeds = [torch.randn(y.shape, generator=g, device=cuda_device),
             torch.randn(s_final.shape, generator=g, device=cuda_device)]
    for used in (1, 2):              # y alone (training), then y and state
        got = torch.autograd.grad((y, s_final)[:used], got_in, seeds[:used],
                                  retain_graph=True)
        assert wkv.launches == before + 1      # no forward launch
        assert wkv_backward.launches == before_bwd + used
        plain = torch.autograd.grad((y_ref, s_ref)[:used], want_in,
                                    seeds[:used], retain_graph=True,
                                    materialize_grads=True)
        wide = torch.autograd.grad(
            (y_wide, s_wide)[:used], wide_in,
            [x.double() for x in seeds[:used]], retain_graph=True,
            materialize_grads=True)
        for name, a, p, x in zip("rkvwu", got, plain, wide, strict=True):
            assert bool(torch.isfinite(a).all()), name
            scale = float(x.abs().max())
            if scale == 0.0:          # w's gradient at S 1 without the state's
                assert float(a.abs().max()) == 0.0, name
                continue
            err = float((a.double() - x).abs().max()) / scale
            control = float((p.double() - x).abs().max()) / scale
            assert err <= min(max(BWD_FACTOR * control, BWD_FLOOR),
                              BWD_TOL), (name, err, control)


@requires_cuda
def test_rwkv_time_mix_trains_on_the_card_as_on_the_cpu(cuda_device):
    cfg = get_config("rwkv6-1.6b", smoke=True)            # fp32
    g = torch.Generator().manual_seed(0)
    p = rwkv.init_time_mix(g, cfg)
    x = torch.randn((2, 96, cfg.d_model), generator=g)

    def run(device):
        leaves = {"x": x.to(device).requires_grad_(),
                  **{k: w.to(device).requires_grad_() for k, w in p.items()}}
        params = {k: leaves[k] for k in p}
        before, before_bwd = wkv.launches, wkv_backward.launches
        with no_tf32():
            out, _, _ = rwkv.time_mix(cfg, params, leaves["x"])
            out.square().sum().backward()
        on_card = int(device.type == "cuda")
        assert wkv.launches == before + on_card
        assert wkv_backward.launches == before_bwd + on_card
        return out.detach().cpu(), {k: t.grad.cpu()
                                    for k, t in leaves.items()}

    out, grads = run(cuda_device)
    want, want_grads = run(torch.device("cpu"))
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
    for name in ("x", "w_r", "w_k", "w_v", "w_g", "w_o", "decay_base",
                 "bonus_u", "w_dec1", "w_dec2"):
        assert bool(torch.isfinite(grads[name]).all()), name
        scale = float(want_grads[name].abs().max())
        assert scale > 0, name
        torch.testing.assert_close(grads[name], want_grads[name], rtol=0,
                                   atol=TOL * scale, msg=name)
