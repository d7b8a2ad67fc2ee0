"""FACADE's language-model step on the multi-pod layout, with values, on
four gloo ranks on the CPU: llama3.2-1b's smoke config in fp32 (n 2, k 2,
degree 1, one local step, 2 sequences of 16 tokens a node, lr 1e-3: the
reference case's values but the cuts), built by
``launch.steps.build_facade_case(mesh=...)`` on a (pod 2, data 1, model
2) debug mesh, where each pod's ranks run their own node: step 2c through
K1's DTensor branch, the local step under the hooks' ``seq_model``, and
``gossip_mix`` and the head aggregation across 'pod'. Each rank of
``tests/torch_facade_pod_world.py`` runs it; one spawn of four processes.

The state is the reference's ``init_facade_state(binding, key, 2, 2,
head_jitter=1e-2)``, carried across by ``interop.lm_params_from_jax``
(through ``torch_caps.JaxDraws.facade_init``, which draws the same
model and head bank from the same key), so that step 2c's choice is no
last-ulp tie; the topology draw is ``JaxDraws``' (the reference round's
split of the state's key), though at n 2 and degree 1 the graph is the
one edge whatever the draw. The batches are the port's draw.

Against ``mesh=None`` on every rank: every leaf of the new state and
the selection losses within 1e-5 of their largest value, the cluster ids
and the round's bytes equal. Against the reference's
``build_facade_case`` on a (pod 2, data 1, model 2) mesh of four forced
host devices, jitted with its ``in_shardings`` and hooks in a subprocess
beside the world, from the same state and batches: the same. And on a
(data 2, model 2) mesh without 'pod', where the nodes are replicated as
the reference's ``pod = None`` branch has them, against ``mesh=None``.
The gaps read: the state 1.2e-7 and the losses 0 against ``mesh=None``,
2.3e-7 and 7.5e-8 against the reference.
"""
from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from torch_worlds import join, near, run_world, start_reference, stop
import torch_facade_pod_world as fpw

TOL = 1e-5
SEED, JITTER, DEGREE = 0, 1e-2, 1

# the reference's FACADE step on a (pod 2, data 1, model 2) mesh of forced
# host devices, its state drawn from argv[1]'s seed, its batches argv[1]'s;
# outputs pickled to argv[2]
REF_SCRIPT = """
import os, pickle, sys
# LLVM's passes off: compiling, not running, is what takes this script's
# time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro.configs
import repro.models.base as base
from repro.core.bindings import make_binding
from repro.core.state import init_facade_state
from repro.launch import shardings, steps
from repro.models import hooks
with open(sys.argv[1], "rb") as f:
    ref = pickle.load(f)
cfg = base.ModelConfig(**ref["cfg"])
base._REGISTRY[ref["arch"]] = lambda smoke=False, c=cfg: c
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 1, 2),
            ("pod", "data", "model"))
case = steps.build_facade_case(ref["arch"], mesh, **ref["case"])  # its hooks
k_init, _ = jax.random.split(jax.random.PRNGKey(ref["seed"]))
state = init_facade_state(make_binding(cfg), k_init, ref["case"]["n_nodes"],
                          ref["case"]["k"], head_jitter=ref["jitter"])
batches = jax.tree.map(jnp.asarray, ref["batches"])
with jax.set_mesh(mesh):
    new, info = jax.jit(case.step_fn, in_shardings=shardings.named(
        mesh, case.in_shardings))(state, batches)
hooks.clear()
out = {"cores": new.cores, "heads": new.heads, "cluster_id": new.cluster_id,
       "info": {k: info[k] for k in ("selection_losses", "cluster_id",
                                     "round_bytes")}}
with open(sys.argv[2], "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, out), f)
"""


def _inputs(tmp):
    """The world's inputs (the reference's initial model and head bank
    through ``JaxDraws``, the round's draw, the port's batches) and the
    reference's (the config, seed, jitter and the same batches)."""
    from repro_torch.core.bindings import make_binding
    from repro_torch.launch import steps
    from torch_caps import JaxDraws

    cfg = fpw.smoke(fpw.ARCH)
    draws = JaxDraws(SEED)
    params, heads_k = draws.facade_init(make_binding(cfg), fpw.K, JITTER)
    perms = draws.perms(fpw.N, DEGREE)
    batches = steps.build_facade_case(
        fpw.ARCH, n_nodes=fpw.N, k=fpw.K, batch_per_node=fpw.BATCH,
        seq=fpw.SEQ, local_steps=fpw.LOCAL_STEPS, device="cpu", seed=SEED,
        cfg=cfg).args[1]
    with open(tmp / "world_in.pkl", "wb") as f:
        pickle.dump({"params": params, "heads_k": heads_k, "perms": perms,
                     "batches": batches}, f)
    case = dict(n_nodes=fpw.N, k=fpw.K, batch_per_node=fpw.BATCH,
                seq=fpw.SEQ, local_steps=fpw.LOCAL_STEPS)
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"arch": fpw.ARCH, "cfg": dataclasses.asdict(cfg),
                     "case": case, "seed": SEED, "jitter": JITTER,
                     "batches": {k: v.numpy() for k, v in batches.items()}},
                    f)


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("podworld")
    _inputs(tmp)
    proc, deadline = start_reference(REF_SCRIPT, tmp / "ref_in.pkl",
                                     tmp / "ref_out.pkl")
    yield tmp, proc, deadline
    stop(proc)


@pytest.fixture(scope="module")
def ranks(world_dir):
    tmp, _, _ = world_dir
    return run_world("torch_facade_pod_world.py", tmp, tmp / "world_in.pkl")


@pytest.fixture(scope="module")
def reference(world_dir):
    tmp, proc, deadline = world_dir
    join([proc], deadline)
    with open(tmp / "ref_out.pkl", "rb") as f:
        return pickle.load(f)


def _leaves(tree):
    import jax
    return jax.tree.leaves(tree)


def _held(got, want, msg):
    """The new state and the round's info of ``got`` against ``want``'s
    (module docstring)."""
    for part in ("cores", "heads"):
        g, w = _leaves(got[part]), _leaves(want[part])
        assert len(g) == len(w) > 0
        for j, (x, y) in enumerate(zip(g, w)):
            near(x, y, TOL, f"{msg} {part} leaf {j}")
    near(got["info"]["selection_losses"], want["info"]["selection_losses"],
         TOL, f"{msg} selection losses")
    for cid in (got["cluster_id"], got["info"]["cluster_id"]):
        np.testing.assert_array_equal(cid, want["info"]["cluster_id"], msg)
    assert float(got["info"]["round_bytes"]) == \
        float(want["info"]["round_bytes"]), msg


def test_the_draw_is_the_one_edge_whatever_it_is():
    """At n 2 and degree 1 every draw gives the graph of one edge (the
    reference's ``random_regular``, ``src/repro/core/topology.py``), so
    the draw the world takes decides nothing."""
    import itertools

    from repro_torch.core import topology

    assert topology.n_perms(DEGREE) == 2
    for perms in itertools.product(([0, 1], [1, 0]), repeat=2):
        adj = topology.random_regular(torch.tensor(perms), fpw.N, DEGREE)
        np.testing.assert_array_equal(adj.numpy(), [[0, 1], [1, 0]])


@pytest.mark.parametrize("mesh", ["pod", "data_model"])
def test_step_on_a_mesh_matches_mesh_none(ranks, mesh):
    for r, got in enumerate(ranks):
        _held(got[mesh], got["none"], f"rank {r} {mesh}")
        assert got[mesh]["round"] == got["none"]["round"] == 1
        assert got[mesh]["launches"] == 0


def test_pod_step_matches_the_reference(ranks, reference):
    """Every rank's whole new state and info against the reference's
    step on its (pod 2, data 1, model 2) mesh."""
    for r, got in enumerate(ranks):
        _held(got["pod"], reference, f"rank {r}")


def test_mesh_none_matches_the_reference(ranks, reference):
    _held(ranks[0]["none"], reference, "mesh=None")


def test_the_choice_of_head_is_no_tie(reference):
    """Both nodes' two heads score more than a hundred times the
    tolerance apart (0.011 and 0.018 of 6.32 apart), so the cluster ids
    compare the choice."""
    losses = reference["info"]["selection_losses"]
    scale = float(np.abs(losses).max())
    assert (np.abs(losses[:, 0] - losses[:, 1]) > 100 * TOL * scale).all()


def test_each_pod_runs_its_own_node(ranks):
    """On the multi-pod layout every rank's one K1 call scores its pod's
    node (k 2 rows of n k 4), and the cluster ids, losses and head bank
    stay on 'pod'; without 'pod' (and with ``mesh=None``) every rank
    scores both nodes."""
    tokens = fpw.BATCH * fpw.SEQ
    d = fpw.smoke(fpw.ARCH).d_model
    for got in ranks:
        assert got["pod"]["k1_calls"] == [(fpw.K, tokens, d)]
        for run in ("none", "data_model"):
            assert got[run]["k1_calls"] == [(fpw.N * fpw.K, tokens, d)]
        pl = got["pod"]["placements"]
        assert pl["cluster_id"] == ["S(0)", "R", "R"]
        assert pl["selection_losses"][0] == "S(0)"
        assert pl["lm_head"][0] == "S(0)"


def test_pod_mesh_1x1x1_is_mesh_none_bit_for_bit():
    """On a one-rank gloo group in this process (started by the mesh,
    taken down after), FACADE's step on ``make_debug_mesh((1, 1, 1),
    ("pod", "data", "model"))`` is the ``mesh=None`` step bit for bit
    (``chip_smoke.py``'s ``lm_mesh_facade`` on the card), its selection
    losses a DTensor (step 2c through K1's DTensor branch)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    kw = dict(n_nodes=fpw.N, k=fpw.K, batch_per_node=fpw.BATCH, seq=fpw.SEQ,
              device="cpu", seed=SEED, cfg=fpw.smoke(fpw.ARCH))
    had = dist.is_initialized()
    try:
        mesh = make_debug_mesh((1, 1, 1), ("pod", "data", "model"),
                               device="cpu")
        plain = steps.build_facade_case(fpw.ARCH, **kw)
        want = plain.step_fn(*plain.args)
        case = steps.build_facade_case(fpw.ARCH, mesh=mesh, **kw)
        got = case.step_fn(*case.args)
        assert isinstance(got[1]["selection_losses"], DTensor)
        got_np, want_np = (fpw._tree_np([s.cores, s.heads, s.cluster_id,
                                         i["selection_losses"]])
                           for s, i in (got, want))
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()
    for x, y in zip(_leaves(got_np), _leaves(want_np), strict=True):
        np.testing.assert_array_equal(x, y)
    assert got[1]["round_bytes"] == want[1]["round_bytes"]
