"""Network simulation on the card: the captured netsim round (the masks,
the bursty channel, the async-gossip buffer and the round's seconds inside
the CUDA graph) against the eager loop, the drained per-round bytes and
seconds against the values each round computes, and K1's launches under
netsim replays.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. No tolerance: on one device the engine
equals the loop bit for bit (the same closures on the same draws), so
every parameter leaf is held with ``torch.equal`` and every history, the
simulated seconds included, with ``==``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.facade_paper import lenet
from repro_torch.core import netwire, runner
from repro_torch.core.bindings import make_binding
from repro_torch.core.engine import WARMUP_ROUNDS, SegmentEngine
from repro_torch.core.runner import ALGOS, TorchDraws, run_experiment
from repro_torch.data import pipeline
from repro_torch.data.synthetic import SynthSpec, make_clustered_data
from repro_torch.kernels.head_select import head_losses
from repro_torch.netsim import NetSchedule, NetworkConfig
from repro_torch.tree import tree_leaves
from torch_caps import cuda_device, requires_cuda  # noqa: F401

CFG = lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=5, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=2, seed=0)
EDGE_V2 = NetworkConfig.preset("edge-v2")


def _data():
    return make_clustered_data(
        SynthSpec(n_classes=4, image_size=16, samples_per_class=8,
                  test_per_class=8, seed=3), (6, 2), ("rot0", "rot180"))


def _same_run(a, b):
    for x, y in zip(tree_leaves(a.models), tree_leaves(b.models),
                    strict=True):
        assert x.device.type == "cuda" and torch.equal(x, y)
    assert a.acc_per_cluster == b.acc_per_cluster
    assert (a.dp, a.eo) == (b.dp, b.eo)
    for col in ("rounds", "bytes", "seconds", "evaled"):
        assert getattr(a.comm, col) == getattr(b.comm, col), col
    assert len(a.cluster_history) == len(b.cluster_history)
    for (r1, c1), (r2, c2) in zip(a.cluster_history, b.cluster_history):
        assert r1 == r2 and np.array_equal(np.asarray(c1), np.asarray(c2))
    assert a.eval_frames == b.eval_frames


@requires_cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_captured_edge_v2_round_equals_the_loop(cuda_device, algo):
    """rounds 5, eval every 2; FACADE with a warmup round (both of its
    rounds captured). Serialized and pipelined against the loop; K1's
    count is the warm-up calls before each capture plus one a replayed
    round."""
    ds = _data()
    kw = dict(KW, device=cuda_device, net=EDGE_V2)
    if algo == "facade":
        kw.update(head_jitter=0.05, warmup_rounds=1)
    loop = run_experiment(algo, CFG, ds, engine=False, **kw)
    head_losses.launches = 0
    eng = run_experiment(algo, CFG, ds, **kw)
    want = KW["rounds"] + 2 * WARMUP_ROUNDS if algo == "facade" else 0
    assert head_losses.launches == want
    _same_run(eng, loop)
    _same_run(run_experiment(algo, CFG, ds, pipeline=True, **kw), loop)
    assert loop.comm.seconds[-1] > 0


@requires_cuda
@pytest.mark.parametrize("algo", ["facade", "dac"])
def test_drained_bytes_and_seconds_are_the_rounds_own(cuda_device, algo):
    """A ``SegmentEngine`` driven directly over 4 rounds of ``edge-v2``:
    the drained ``[L]`` bytes and seconds equal, as float32 values, what
    ``netwire.net_round`` gives each round run eagerly on the same draws
    and carry; K1 ran once a replayed round plus its warm-up call."""
    ds = _data()
    n, h, b, deg = ds.n_nodes, 2, 4, 2
    binding = make_binding(CFG)
    program = runner.algo_program(algo, binding, n, 2, degree=deg, lr=0.05,
                                  head_jitter=0.05)
    train_x, train_y = pipeline.place(ds, cuda_device)

    def start(seed):
        draws = TorchDraws(seed)
        setup = program.setup(draws, cuda_device)
        sched = NetSchedule(EDGE_V2, n, draws)
        return draws, sched, runner._initial_carry(setup, sched, n,
                                                   cuda_device)

    draws, sched, carry = start(5)
    state, chan, gossip, fault, tstate = carry
    want_b, want_s = [], []
    for rnd in range(4):
        idx = draws.batch_indices(n, h, b, train_x.shape[1])
        topo = ((draws.perms(n, deg),) if algo == "facade"
                else (draws.gumbel(n),))
        state, chan, gossip, fault, tstate, info, secs = netwire.net_round(
            program.round_fn, program.mixable_of, state, chan, gossip, fault,
            pipeline.sample_round_batches(idx.to(cuda_device), train_x,
                                          train_y),
            tuple(t.to(cuda_device) for t in topo), EDGE_V2,
            sched.round(rnd).to(cuda_device), h)
        want_b.append(float(info["round_bytes"]))
        want_s.append(float(secs))

    eng = SegmentEngine(program.round_fn, n=n, local_steps=h, batch_size=b,
                        device=cuda_device,
                        track_cluster=program.track_cluster,
                        topology_draw=program.topology_draw, degree=deg,
                        net=EDGE_V2, mixable_of=program.mixable_of)
    draws, sched, carry = start(5)
    carry = eng.init_carry(*carry)
    head_losses.launches = 0
    carry, outs = eng.run_segment(carry, 0, 4, train_x, train_y, draws,
                                  net=sched)
    torch.cuda.synchronize()
    assert head_losses.launches == (4 + WARMUP_ROUNDS
                                    if algo == "facade" else 0)
    assert outs["round_bytes"].tolist() == want_b
    assert outs["round_s"].tolist() == want_s
    assert all(s > 0 for s in want_s)
    for x, y in zip(tree_leaves(carry.state.params if algo == "dac"
                                else carry.state.cores),
                    tree_leaves(state.params if algo == "dac"
                                else state.cores), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(carry.chan.bad, chan.bad)
    assert torch.equal(carry.gossip.age, gossip.age)
