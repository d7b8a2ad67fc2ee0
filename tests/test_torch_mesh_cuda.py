"""The node mesh on one card: ``mesh=(1,)`` starts a one-rank NCCL group
(its rendezvous a file store under the temp directory), and each round is
captured in a CUDA graph with its all-gather inside. Against ``mesh=None``
the run is the same bit for bit, K1 runs inside each replayed FACADE
round, and a mesh of 2 on a world of 1 is refused.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch.distributed as dist

from repro_torch.core.engine import WARMUP_ROUNDS
from repro_torch.core.runner import ALGOS, run_experiment
from repro_torch.kernels.head_select import head_losses
from repro_torch.netsim import NetworkConfig
from repro_torch.obs import Obs, ObsConfig
from repro_torch.resil import FaultConfig
from test_torch_netsim_cuda import CFG, KW, _data, _same_run
from test_torch_obs_cuda import _tables_equal
from torch_caps import cuda_device, requires_cuda  # noqa: F401

# the reference's full stack (tests/test_mesh.py)
FULL = dataclasses.replace(
    NetworkConfig.preset("edge-v2"),
    faults=FaultConfig(crash_rate=0.1, restart_rate=0.5, corrupt_rate=0.2,
                       corrupt_mode="nan"))
ROUNDS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The one-rank group ``mesh=(1,)`` starts, taken down after the
    module."""
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


@requires_cuda
@pytest.mark.parametrize("variant", ["plain", "full"])
@pytest.mark.parametrize("algo", ALGOS)
def test_captured_mesh1_round_is_mesh_none(cuda_device, algo, variant):
    """8 rounds, eval every 4: the captured ``mesh=(1,)`` rounds give
    ``mesh=None``'s run bit for bit (under the full stack the frames too),
    and FACADE's K1 runs once a replayed round plus its warm-up call (9)."""
    ds = _data()
    kw = dict(KW, device=cuda_device, rounds=ROUNDS, eval_every=4)
    if algo == "facade":
        kw.update(head_jitter=0.05)
    obs_a = obs_b = None
    if variant == "full":
        kw["net"] = FULL
        obs_a, obs_b = Obs(ObsConfig()), Obs(ObsConfig())
    ref = run_experiment(algo, CFG, ds, obs=obs_a, **kw)
    head_losses.launches = 0
    got = run_experiment(algo, CFG, ds, obs=obs_b, mesh=(1,), **kw)
    want = ROUNDS + WARMUP_ROUNDS if algo == "facade" else 0
    assert head_losses.launches == want
    _same_run(ref, got)
    if obs_a is not None:
        _tables_equal(obs_a.frames_table(), obs_b.frames_table())


@requires_cuda
def test_two_ranks_on_a_world_of_one_are_refused(cuda_device):
    ds = _data()
    run_experiment("el", CFG, ds, device=cuda_device, mesh=(1,), **KW)
    with pytest.raises(RuntimeError, match="needs 2 devices, have 1"):
        run_experiment("el", CFG, ds, device=cuda_device, mesh=(2,), **KW)
