"""Node faults on the card: the captured faulty round (the crash chain,
NaN corruption and the robust guard inside the CUDA graph) against the
eager loop, and K1 against its plain version on the non-finite inputs an
unguarded faulty round gives it.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. On one device the engine equals the
loop bit for bit, so every parameter leaf is held with ``torch.equal``
and every history, the simulated seconds included, with ``==``.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.core.engine import WARMUP_ROUNDS
from repro_torch.core.runner import run_experiment
from repro_torch.kernels.head_select import head_losses, head_losses_ref
from repro_torch.netsim import NetworkConfig
from repro_torch.resil import FaultConfig
from repro_torch.tree import tree_leaves
from test_torch_netsim_cuda import CFG, KW, _data, _same_run
from torch_caps import cuda_device, requires_cuda  # noqa: F401

NAN_FAULTS = NetworkConfig.preset(
    "edge-v2", faults=FaultConfig(crash_rate=0.3, restart_rate=0.5,
                                  corrupt_rate=0.3, corrupt_mode="nan"))


@requires_cuda
@pytest.mark.parametrize("algo", ["facade", "dac"])
def test_engine_equals_the_loop_under_nan_faults(cuda_device, algo):
    """rounds 5, eval every 2; FACADE with a warmup round (both of its
    rounds captured). Serialized and pipelined against the loop, the
    parameters finite (the guard on); K1's count is the warm-up calls
    before each capture plus one a replayed round."""
    ds = _data()
    kw = dict(KW, device=cuda_device, net=NAN_FAULTS)
    if algo == "facade":
        kw.update(head_jitter=0.05, warmup_rounds=1)
    loop = run_experiment(algo, CFG, ds, engine=False, **kw)
    head_losses.launches = 0
    eng = run_experiment(algo, CFG, ds, **kw)
    want = KW["rounds"] + 2 * WARMUP_ROUNDS if algo == "facade" else 0
    assert head_losses.launches == want
    _same_run(eng, loop)
    _same_run(run_experiment(algo, CFG, ds, pipeline=True, **kw), loop)
    assert all(bool(torch.isfinite(leaf).all())
               for leaf in tree_leaves(eng.models))


def _non_finite_case(device):
    """FACADE-shape inputs (n 4, K 2, T 8, D 513, V 10, the bias folded)
    with node 0 a token of NaN features, node 1 a head of NaN weights,
    node 2 a +inf bias weight in a column none of its labels names and
    node 3 a head of +inf weights."""
    g = torch.Generator().manual_seed(21)
    feats = 0.5 * torch.randn((4, 8, 513), generator=g)
    feats[..., -1] = 1.0
    heads = 0.05 * torch.randn((4, 2, 513, 10), generator=g)
    labels = torch.randint(0, 10, (4, 8), generator=g, dtype=torch.int32)
    feats[0, 3] = float("nan")
    heads[1, 1] = float("nan")
    free = sorted(set(range(10)) - set(labels[2].tolist()))[0]
    heads[2, 0, -1, free] = float("inf")
    heads[3, 1] = float("inf")
    return feats.to(device), heads.to(device), labels.to(device)


@requires_cuda
def test_kernel_matches_its_plain_version_on_non_finite_inputs(cuda_device):
    feats, heads, labels = _non_finite_case(cuda_device)
    got = head_losses(feats, heads, labels)
    want = head_losses_ref(feats, heads, labels)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isposinf(), want.isposinf())
    fin = torch.isfinite(want)
    assert int((~fin).sum()) == 5
    rel = ((got[fin] - want[fin]).abs() / want[fin].abs().clamp(min=1))
    assert float(rel.max()) <= 2e-5
    assert got.argmin(1).tolist() == want.argmin(1).tolist() == [0, 1, 1, 1]
