"""Run telemetry on the card: the frame computed inside the captured round
(one ``[F]`` row written before the carry is overwritten, copied into the
segment's ``[L, F]`` buffer and drained with the cluster ids) against the
eager loop's, an observed run against the unobserved one, and K1's
launches in FACADE's observed replayed rounds.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. On one device the engine equals the
loop bit for bit, so every parameter leaf is held with ``torch.equal``,
every history with ``==`` and every frame field with
``np.testing.assert_array_equal``.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.core.engine import WARMUP_ROUNDS
from repro_torch.core.runner import ALGOS, run_experiment
from repro_torch.kernels.head_select import head_losses
from repro_torch.netsim import NetworkConfig
from repro_torch.obs import FRAME_FIELDS, Obs, ObsConfig
from repro_torch.resil import FaultConfig
from test_torch_netsim_cuda import CFG, KW, _data, _same_run
from torch_caps import cuda_device, requires_cuda  # noqa: F401

FAULTS = FaultConfig(crash_rate=0.4, restart_rate=0.6, corrupt_rate=0.3,
                     corrupt_mode="nan", restart_mode="reset")


def _tables_equal(a: dict, b: dict):
    assert set(a) == set(b) == {"round"} | set(FRAME_FIELDS)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@requires_cuda
@pytest.mark.parametrize("preset", [None, "edge-v2", "faults"])
@pytest.mark.parametrize("algo", ALGOS)
def test_observed_engine_is_the_unobserved_run_and_the_loops_frames(
        cuda_device, algo, preset):
    """rounds 5, eval every 2; FACADE with a warmup round (both of its
    rounds captured): the observed engine, serialized and pipelined, is
    the unobserved engine's run bit for bit, its frames are the observed
    loop's bit for bit, and K1 runs once a replayed round plus the
    warm-up calls before each capture."""
    ds = _data()
    net = {None: None, "edge-v2": NetworkConfig.preset("edge-v2"),
           "faults": NetworkConfig.preset("edge-v2", faults=FAULTS)}[preset]
    kw = dict(KW, device=cuda_device, net=net)
    if algo == "facade":
        kw.update(head_jitter=0.05, warmup_rounds=1)
    plain = run_experiment(algo, CFG, ds, **kw)
    loop_obs = Obs(ObsConfig())
    run_experiment(algo, CFG, ds, engine=False, obs=loop_obs, **kw)
    head_losses.launches = 0
    obs = Obs(ObsConfig())
    eng = run_experiment(algo, CFG, ds, obs=obs, **kw)
    want = KW["rounds"] + 2 * WARMUP_ROUNDS if algo == "facade" else 0
    assert head_losses.launches == want
    _same_run(eng, plain)
    _tables_equal(obs.frames_table(), loop_obs.frames_table())
    piped = Obs(ObsConfig())
    _same_run(run_experiment(algo, CFG, ds, obs=piped, pipeline=True, **kw),
              plain)
    _tables_equal(piped.frames_table(), loop_obs.frames_table())
    t = obs.frames_table()
    assert t["round"].tolist() == list(range(1, KW["rounds"] + 1))
    np.testing.assert_array_equal(t["stale_hist"].sum(1), ds.n_nodes)
    assert np.isfinite(t["param_norm"]).all() or preset == "faults"


@requires_cuda
def test_k1_runs_once_a_replayed_observed_round(cuda_device):
    """A second observed run through one cache replays the captured
    rounds: K1's count is exactly the rounds, and the frames are the first
    run's."""
    from repro_torch.core.cache import EngineCache
    ds = _data()
    cache = EngineCache()
    kw = dict(KW, device=cuda_device, head_jitter=0.05, cache=cache)
    first = Obs(ObsConfig())
    run_experiment("facade", CFG, ds, obs=first, **kw)
    head_losses.launches = 0
    again = Obs(ObsConfig())
    run_experiment("facade", CFG, ds, obs=again, **kw)
    assert head_losses.launches == KW["rounds"]
    _tables_equal(again.frames_table(), first.frames_table())
