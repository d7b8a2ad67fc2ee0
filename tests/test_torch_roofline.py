"""The port's roofline (``repro_torch.roofline``) and single-card dry run
(``repro_torch.launch.dryrun``) on the CPU: ``model_flops`` and
``row()``'s keys against the reference's, ``active_param_count`` on
fake tensors at full size against the reference's on
``jax.eval_shape``, the counted FLOPs of a llama smoke prefill and train
step against this file's analytic count (within 0.1%), the byte count's
rules, the sequential loops' one-op stand-ins, and the dry run's JSON
lines for one traced case and one skipped pair."""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
import repro_torch.configs  # noqa: F401  (registry)
from repro.models import api as ref_api
from repro.models.base import get_config as ref_get_config
from repro.roofline import analysis as ref_analysis
from repro_torch.kernels.rwkv6 import wkv_train
from repro_torch.kernels.rwkv6.ref import wkv_scan
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import HW
from repro_torch.models import api, ssm
from repro_torch.models.base import get_config
from repro_torch.roofline import (RooflineReport, analyze_step, count_step,
                                  model_flops)

torch.set_num_threads(1)


def _ref_active_param_count():
    """The reference dry run's ``active_param_count``. Importing the module
    sets ``XLA_FLAGS`` for 512 host devices first; the variable is put back
    at once, so no later backend in this process sees it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import active_param_count
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return active_param_count


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("n,t", [(1_235_814_400, 1_048_576), (7, 3),
                                 (314_000_000_000, 128)])
def test_model_flops_equals_the_reference(n, t, kind):
    assert model_flops(n, t, kind) == ref_analysis.model_flops(n, t, kind)


def test_row_has_the_reference_keys():
    kw = dict(arch="a", shape="s", mesh="m", chips=1, hlo_flops=2e12,
              hlo_bytes=3e9, collective_bytes=0.0, collective_counts={},
              t_compute=1.0, t_memory=2.0, t_collective=0.0,
              model_flops=1e12, bytes_per_device=4e9)
    got, want = RooflineReport(**kw), ref_analysis.RooflineReport(**kw)
    assert got.row() == want.row()
    assert list(got.row()) == list(want.row())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "grok-1-314b", "rwkv6-1.6b",
                                  "whisper-tiny", "llava-next-34b"])
def test_active_param_count_at_full_size_equals_the_reference(arch):
    """The port's parameters on fake tensors (nothing allocated) against
    the reference's ``ShapeDtypeStruct``s; MoE's expert stacks at
    experts_per_token / n_experts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    sds = jax.eval_shape(lambda k: ref_api.init_params(rcfg, k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    with FakeTensorMode():
        params = api.init_params(cfg, torch.Generator())
    assert dryrun.active_param_count(cfg, params) == \
        _ref_active_param_count()(rcfg, sds)


# --------------------------------------------------------------------------
def _llama_smoke_counts(b, s):
    """This file's count of llama3.2-1b smoke's matmul FLOPs a forward
    pass (2 a multiply-add): per layer the q, k, v and o projections, the
    SwiGLU's three products and the plain attention's two [S, S]
    products a head (every score: the plain version masks, it does not
    skip); the tied head's product a position; and the layers' last
    product (SwiGLU's down projection), whose output no backward needs,
    so a non-reentrant checkpoint's recompute stops before it."""
    cfg = get_config("llama3.2-1b", smoke=True)
    d, hq, hkv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, cfg.d_ff, cfg.vocab_size)
    t = b * s
    per_layer = (2 * t * d * (hq + 2 * hkv) * hd + 2 * t * hq * hd * d
                 + 3 * 2 * t * d * f + 2 * 2 * b * hq * s * s * hd)
    return (cfg, cfg.n_layers * per_layer, 2 * d * v,
            cfg.n_layers * 2 * t * f * d)


def test_counted_prefill_flops_equal_the_analytic_count():
    b, s = 2, 48
    cfg, layers, head, _ = _llama_smoke_counts(b, s)
    case = steps.build_case("llama3.2-1b", "prefill_32k", device="cpu",
                            cfg=cfg, batch=b)
    batch = {"tokens": case.args[1]["tokens"][:, :s]}
    cost = count_step(case.step_fn, (case.args[0], batch))
    want = layers + b * head               # logits at the last position
    assert abs(cost.flops - want) <= 1e-3 * want


@pytest.mark.parametrize("remat", [True, False])
def test_counted_train_flops_equal_the_analytic_count(remat):
    """Forward, backward (two products a forward product) and, under
    remat, the layers' forward once more but their last product; the
    loss's head over every position."""
    b, s = 2, 48
    cfg, layers, head, last = _llama_smoke_counts(b, s)
    case = steps.build_case("llama3.2-1b", "train_4k", device="cpu",
                            cfg=cfg, batch=b, remat=remat)
    batch = {k: x[:, :s] for k, x in case.args[2].items()}
    cost = count_step(case.step_fn, (case.args[0], case.args[1], batch))
    want = layers * 3 + (layers - last if remat else 0) + 3 * b * s * head
    assert abs(cost.flops - want) <= 1e-3 * want


def test_bytes_count_inputs_and_outputs_and_not_views():
    a, w = torch.ones(4, 8), torch.ones(8, 16)
    cost = count_step(lambda a, w: (a.t().t() @ w).view(-1), (a, w))
    assert cost.bytes == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    assert cost.peak_bytes == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    assert cost.flops == 2 * 4 * 8 * 16


def test_analyze_step_divides_by_the_card():
    cost = count_step(lambda a, w: a @ w, (torch.ones(64, 64),
                                           torch.ones(64, 64)))
    rep = analyze_step(cost, arch="x", shape="y", mesh_name="h100x1",
                       chips=1, hw=HW, n_params_active=10, n_tokens=3,
                       kind="prefill")
    assert rep.t_compute == cost.flops / 989e12
    assert rep.t_memory == cost.bytes / 3.35e12
    assert rep.t_collective == 0.0 and rep.dominant == "memory"
    assert rep.model_flops == 60.0


# --------------------------------------------------------------------------
def test_wkv_stand_in_counts_what_the_loop_counts():
    """On fake tensors ``wkv_scan`` is one op: its value on real tensors
    is the loop's, its gradients the loop's, and the FLOPs counted for a
    training call (forward, the backward's recompute and its backward)
    equal those counted through the loop on real tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.rwkv6 import ref
    g = torch.Generator().manual_seed(0)
    shape = (2, 5, 3, 8)
    xs = [torch.randn(shape, generator=g, dtype=torch.float64)
          for _ in range(4)]
    u = torch.randn((3, 8), generator=g, dtype=torch.float64)
    s0 = torch.randn((2, 3, 8, 8), generator=g, dtype=torch.float64)
    for got, want in zip(ref._WKV_OP(*xs, u, s0), ref._wkv_loop(*xs, u,
                                                                s0)):
        assert torch.equal(got, want)

    def train(*xs):
        leaves = [x.requires_grad_() for x in xs]
        y, _ = wkv_train(*leaves)
        return torch.autograd.grad(y, leaves, torch.ones_like(y))

    leaves = [x.float() for x in xs] + [u.float()]
    real = count_step(train, [x.clone() for x in leaves])
    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(x) for x in leaves]
    fake = count_step(train, fakes, mode)
    assert fake.flops == real.flops == 8 * 2 * 5 * 3 * 8 * 8
    for a, b in zip(real.out, train(*[x.clone() for x in leaves])):
        torch.testing.assert_close(a, b)
    ys = [x.clone().requires_grad_() for x in xs + [u, s0]]
    got = torch.autograd.grad(ref._WKV_OP(*ys)[0].sum(), ys)
    want = torch.autograd.grad(ref._wkv_loop(*ys)[0].sum(), ys)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    assert wkv_scan(*xs, u)[0].shape == shape


def test_ssm_stand_in_equals_the_loop():
    """hymba's selective scan: the stand-in's values and gradients are the
    loop's; neither counts FLOPs (elementwise)."""
    g = torch.Generator().manual_seed(1)
    da, dbu = (torch.rand((2, 6, 4, 3), generator=g, dtype=torch.float64)
               for _ in range(2))
    h0 = torch.randn((2, 4, 3), generator=g, dtype=torch.float64)
    ins = [x.requires_grad_() for x in (da, dbu, h0)]
    got, want = ssm._SCAN_OP(*ins), ssm._scan_loop(*ins)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ga = torch.autograd.grad(got[0].sum() + got[1].sum(), ins)
    gb = torch.autograd.grad(want[0].sum() + want[1].sum(), ins)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b)
    assert count_step(ssm._SCAN_OP, (da, dbu, h0)).flops == 0


# --------------------------------------------------------------------------
def test_dryrun_writes_a_traced_case_and_a_skipped_pair(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--out", str(out), "--tag", "t"]) == 0
    assert dryrun.main(["--arch", "grok-1-314b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "skipped"]
    ok, skipped = recs
    keys = set(ref_analysis.RooflineReport(
        "a", "s", "m", 1, 1.0, 1.0, 0.0, {}, 1.0, 1.0, 0.0, 1.0,
        1.0).row())
    assert keys <= set(ok)
    assert ok["mesh"] == "h100x1" and ok["chips"] == 1 and ok["tag"] == "t"
    assert ok["t_trace_s"] >= 0 and "t_compile_s" not in ok
    assert ok["hlo_gflops_per_dev"] > 0 and ok["t_collective_s"] == 0.0
    n_act = dryrun.active_param_count(
        get_config("llama3.2-1b"),
        steps.build_case("llama3.2-1b", "long_500k", abstract=True).args[0])
    np.testing.assert_allclose(ok["model_gflops"], 2 * n_act / 1e9)
    assert skipped["reason"] == \
        "full-attention arch; no 500k decode variant"
    assert skipped["arch"] == "grok-1-314b" and "dominant" not in skipped
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert [r["status"] for r in printed] == ["ok", "skipped"]


def test_dryrun_refuses_the_mesh_flags():
    for flag in ("--multi-pod", "--no-fsdp", "--seq-model",
                 "--no-act-sharding", "--unroll"):
        with pytest.raises(SystemExit):
            dryrun.main(["--all", flag])
