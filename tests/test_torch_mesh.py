"""The node mesh (``run_experiment(mesh=)``, ``SegmentEngine(mesh=)``,
``core/meshctx``) on the CPU, in gloo worlds, against ``mesh=None`` and
the reference (``tests/test_mesh.py``'s contract):

* ``mesh=(1,)`` is ``mesh=None`` bit for bit for the five algorithms, with
  no medium, under ``edge-v2`` with NaN-corrupting faults and telemetry,
  with ``reset`` restarts and noise corruption, and under an adaptive
  topology policy (a one-rank gloo group this process starts itself);
* worlds of 2 and 4 ranks (one process a rank, spawned once each for the
  module, ``tests/torch_mesh_world.py``) against ``mesh=None`` on the
  reference's 8-node data: bytes, seconds and frame counts exact, cluster
  histories equal (``head_jitter > 0``), accuracies within 0.1, frame
  norms within 1e-5; whether a run came out bit for bit is reported, not
  asserted;
* a ``mesh=(2,)`` run killed after its first segment and resumed equals
  the uninterrupted one bit for bit, and FACADE on two ranks from the
  reference's draws (``torch_caps.JaxDraws``) matches the reference's
  ``run_experiment``;
* the cache key, the validation errors, and ``normalize`` and
  ``node_spec`` case for case against ``repro.core.meshctx``.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import facade_paper as ref_configs
from repro.core import meshctx as ref_meshctx
from repro.core import runner as ref_runner
from repro_torch.core import meshctx
from repro_torch.core.cache import EngineCache, EngineSpec
from repro_torch.core.runner import run_experiment
from repro_torch.launch.mesh import make_node_mesh
from torch_mesh_world import (ALGOS, CFG, KW, RESUME_KW, VARIANTS, data,
                              run, summary)

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 0.1                # the reference's accuracy bound on a real mesh
NORM_TOL = 1e-5
JOIN_S = 150             # a world that has not finished by then fails
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both worlds, started together once for the module: ``{world: (out
    path, [rank process])}``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]),
        OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        out = str(tmp / "out")
        procs[world] = (out, [subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_mesh_world.py"),
             str(rank), str(world), str(tmp / "store"), out], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for rank in range(world)])
    yield procs
    for _, ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def refs(spawned):
    """``mesh=None`` runs of the five on the 8-node data, made while the
    worlds run."""
    ds = data((6, 2))
    got = {(algo, variant): run(algo, variant, ds)
           for algo in ALGOS for variant in VARIANTS}
    for algo in ("facade", "dac"):
        got[("whole", algo)] = run(algo, "full", ds, **RESUME_KW)
    return got


@pytest.fixture(scope="module")
def ref_facade(spawned):
    """The reference's own FACADE run on the 8-node data (its per-round
    loop, which its engine equals), made while the worlds run."""
    kw = {k: v for k, v in KW.items() if k != "device"}
    return ref_runner.run_experiment(
        "facade", ref_configs.lenet(smoke=True).replace(n_classes=4),
        data((6, 2)), engine=False, **kw)


@pytest.fixture(scope="module")
def worlds(spawned, refs, ref_facade):
    """Each rank's results by world, the ranks' stderr last. A rank that
    fails or hangs fails the tests that read it (the ranks' process-group
    timeout is 90 s; the join gives up after 150 s)."""
    deadline = time.monotonic() + JOIN_S
    got = {}
    for world, (out, ps) in spawned.items():
        errs = []
        for p in ps:
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
                err = f"timed out after {JOIN_S} s\n{err}"
            errs.append(err if p.returncode else "")
        got[world] = [None if errs[r] else
                      pickle.load(open(f"{out}.{r}", "rb"))
                      for r in range(world)] + [errs]
    return got


@pytest.fixture(scope="module")
def tiny_ds():
    return data((3, 1))


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """``mesh=(1,)`` starts a one-rank gloo group in this process; it is
    taken down after the module."""
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


def _ranks(worlds, world):
    *ranks, errs = worlds[world]
    failed = [f"rank {r}: {e[-2000:]}" for r, e in enumerate(errs) if e]
    assert not failed, "\n".join(failed)
    return ranks


def _assert_bit_for_bit(a, b):
    for key in ("acc", "fair", "dp", "eo", "final", "rounds", "bytes",
                "seconds", "evaled"):
        assert a[key] == b[key], key
    assert len(a["cids"]) == len(b["cids"])
    for (r1, c1), (r2, c2) in zip(a["cids"], b["cids"]):
        assert r1 == r2
        np.testing.assert_array_equal(c1, c2)
    assert len(a["models"]) == len(b["models"])
    for x, y in zip(a["models"], b["models"]):
        np.testing.assert_array_equal(x, y)
    if a.get("frames") is not None or b.get("frames") is not None:
        for key in a["frames"]:
            np.testing.assert_array_equal(a["frames"][key], b["frames"][key])


def _assert_close(ref, got):
    """The reference's contract on a real mesh, and ours on top."""
    assert got["rounds"] == ref["rounds"]
    assert got["bytes"] == ref["bytes"]                    # exact
    assert got["seconds"] == ref["seconds"]                # exact
    assert got["evaled"] == ref["evaled"]
    assert len(got["cids"]) == len(ref["cids"])
    for (r1, c1), (r2, c2) in zip(got["cids"], ref["cids"]):
        assert r1 == r2
        np.testing.assert_array_equal(c1, c2)
    for (r1, a), (r2, b) in zip(got["acc"], ref["acc"]):
        assert r1 == r2
        np.testing.assert_allclose(a, b, atol=TOL)
    assert abs(got["dp"] - ref["dp"]) <= TOL
    assert abs(got["eo"] - ref["eo"]) <= TOL
    if ref.get("frames") is not None:
        for key, want in ref["frames"].items():
            have = got["frames"][key]
            if key in ("update_norm", "param_norm"):
                np.testing.assert_allclose(have, want, rtol=NORM_TOL,
                                           atol=NORM_TOL)
            else:
                np.testing.assert_array_equal(have, want)


def _bit_for_bit(a, b) -> bool:
    try:
        _assert_bit_for_bit(a, b)
    except AssertionError:
        return False
    return True


# ------------------------------------------- mesh=(1,) bit for bit ------
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("algo", ALGOS)
def test_mesh1_is_mesh_none_bit_for_bit(algo, variant, tiny_ds):
    """A one-rank mesh runs the sharded code path (the gathers, the row
    blocks, the rank's rows of the draws) and may reorder nothing: the
    models, histories and frames equal ``mesh=None``'s."""
    ref = run(algo, variant, tiny_ds)
    got = run(algo, variant, tiny_ds, mesh=(1,))
    _assert_bit_for_bit(ref, got)


def test_mesh1_through_a_shared_cache(tiny_ds):
    """``mesh=(1,)`` through one ``EngineCache``: one miss, then hits, and
    still ``mesh=None``'s run."""
    cache = EngineCache()
    ref = summary(run_experiment("facade", CFG, tiny_ds, **KW))
    got = summary(run_experiment("facade", CFG, tiny_ds, mesh=(1,),
                                 cache=cache, **KW))
    _assert_bit_for_bit(ref, got)
    assert cache.misses == 1 and cache.hits == 0
    again = summary(run_experiment("facade", CFG, tiny_ds, mesh=1,
                                   cache=cache, **KW))
    _assert_bit_for_bit(ref, again)
    assert cache.misses == 1 and cache.hits == 1


def test_mesh_is_a_cache_key_axis():
    base = EngineSpec(algo="el", cfg=CFG, n=4, k=2, degree=2,
                      local_steps=2, batch_size=4, lr=0.05,
                      device=torch.device("cpu"))
    meshed = dataclasses.replace(base, mesh=(1,))
    assert base != meshed and hash(base) != hash(meshed)
    assert "mesh=(1,)" in repr(meshed)


# ---------------------------------------------- worlds of 2 and 4 -------
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("world", WORLDS)
def test_world_matches_mesh_none(world, algo, worlds, refs):
    """Every rank of the world returns the same run, and it is
    ``mesh=None``'s within the reference's bounds, plain and under each
    stack of ``VARIANTS``."""
    ranks = _ranks(worlds, world)
    for variant in VARIANTS:
        ref = refs[(algo, variant)]
        got = ranks[0][(algo, variant)]
        for other in ranks[1:]:
            _assert_bit_for_bit(got, other[(algo, variant)])
        _assert_close(ref, got)
        print(f"{algo} {variant} on {world} ranks: bit for bit with "
              f"mesh=None: {_bit_for_bit(ref, got)}")


@pytest.mark.parametrize("algo", ("facade", "dac"))
def test_drivers_on_two_ranks_match_mesh_none(algo, worlds, refs):
    """FACADE pipelined and DAC serialized, one segment a round, on two
    ranks under the full stack: ``mesh=None``'s run within the bounds."""
    for rank in _ranks(worlds, 2):
        _assert_close(refs[("whole", algo)], rank[("whole", algo)])


@pytest.mark.parametrize("algo", ("facade", "dac"))
def test_kill_and_resume_on_two_ranks(algo, worlds):
    """Killed at its third dispatch (FACADE pipelined, DAC not) and
    resumed from the checkpoint rank 0 wrote: the uninterrupted
    ``mesh=(2,)`` run bit for bit, frames included."""
    for rank in _ranks(worlds, 2):
        _assert_bit_for_bit(rank[("whole", algo)], rank[("resumed", algo)])


def test_facade_on_two_ranks_matches_the_reference(worlds, ref_facade):
    """FACADE on two ranks from the reference's draws against the
    reference's own ``run_experiment`` on the same data."""
    got = _ranks(worlds, 2)[0][("jax", "facade")]
    want = ref_facade
    assert got["rounds"] == list(want.comm.rounds)
    assert got["bytes"] == list(want.comm.bytes)
    for (r1, a), (r2, b) in zip(got["acc"], want.acc_per_cluster):
        assert r1 == r2
        np.testing.assert_allclose(a, b, atol=TOL)
    assert len(got["cids"]) == len(want.cluster_history)
    for (r1, c1), (r2, c2) in zip(got["cids"], want.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, np.asarray(c2))


# ---------------------------------------------------- validation -------
def test_mesh_must_divide_n(tiny_ds):
    with pytest.raises(ValueError, match="divide"):
        run_experiment("el", CFG, tiny_ds, mesh=(3,), **KW)      # n = 4


def test_mesh_needs_the_engine(tiny_ds):
    with pytest.raises(ValueError, match="needs the segment engine"):
        run_experiment("el", CFG, tiny_ds, mesh=(1,), engine=False, **KW)


def test_more_ranks_than_the_group_is_refused(tiny_ds):
    """A mesh of 2 in a process whose group has 1 rank (or none) names
    ``torchrun`` and the counts."""
    with pytest.raises(RuntimeError, match="torchrun"):
        run_experiment("el", CFG, tiny_ds, mesh=(2,), **KW)


def test_make_node_mesh_on_the_cpu():
    mesh = make_node_mesh(1, device="cpu")
    assert mesh.mesh_dim_names == (meshctx.NODE_AXIS,)
    assert mesh.size() == 1 and meshctx.normalize(mesh) == (1,)
    assert meshctx.current() is None
    with meshctx.activate(mesh):
        assert meshctx.current() is mesh
    assert meshctx.current() is None


# ------------------------------- the rules against the reference's -----
NORMALIZE = [None, 8, (8,), [4], (1,), (2, 4), (0,), ()]


def _outcome(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return ("ValueError", "one axis" in str(e), "at least 1" in str(e))


@pytest.mark.parametrize("arg", NORMALIZE, ids=[repr(a) for a in NORMALIZE])
def test_normalize_matches_the_reference(arg):
    assert _outcome(meshctx.normalize, arg) == \
        _outcome(ref_meshctx.normalize, arg)


NODE_SPEC = [(6, 3, 2), (6,), (5, 3), (), (2,)]


@pytest.mark.parametrize("shape", NODE_SPEC,
                         ids=[repr(s) for s in NODE_SPEC])
def test_node_spec_matches_the_reference(shape):
    """``Shard(0)`` exactly where the reference's spec puts the node axis
    first, ``Replicate()`` where it replicates (n = 6)."""
    from torch.distributed.tensor import Replicate, Shard

    n = 6
    ref = ref_meshctx.node_spec(np.zeros(shape), n)
    got = meshctx.node_spec(torch.zeros(shape), n)
    if len(ref) and ref[0] == ref_meshctx.NODE_AXIS:
        assert got == Shard(0)
    else:
        assert got == Replicate()
