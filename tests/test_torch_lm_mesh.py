"""The LM steps on a mesh of four gloo ranks on the CPU: llama3.2-1b's
smoke prefill, decode and AdamW train step and rwkv6-1.6b's smoke
prefill, built by ``launch.steps.build_case(mesh=...)`` on a (data 2,
model 2) debug mesh in fp32, against the same steps with ``mesh=None``
from the same seed (each rank of ``tests/torch_lm_mesh_world.py`` runs
both; one spawn of four processes). Outputs within 1e-5 of the largest
value; the train step's new parameters within 1e-5 where the gradient
exceeds 1e-6 and within two steps of the learning rate elsewhere, as
``tests/test_torch_steps.py`` holds it against the reference. Every rank
gets the same whole outputs; the CPU wrappers count no launches. On a
one-rank group in the test's own process, mesh (1, 1) is ``mesh=None``
bit for bit (the four steps and rwkv's train step).

The same four steps are held against the reference's (``repro.launch.
steps.build_case``) on a (data 2, model 2) mesh of four forced host
devices, jitted with its ``in_shardings`` from ``repro.launch.shardings``
and its activation hooks, in a subprocess that runs beside the world:
both from the reference's parameters (``repro.models.api.init_params``,
carried across by ``interop.lm_params_from_jax``) and the port's other
arguments, every leaf that a dim of divides FSDP-sharded on both sides
(their size floor lowered to 0). Outputs within 1e-5 of the largest
value, the train step by the rule above. And for every arch, a mesh's
parameters (``steps.init_params_on_mesh``) are rank 0's shards of
``api.init_params``' draw from the same seed, on a fake world."""
from __future__ import annotations

import pickle
import sys

import numpy as np
import pytest

from torch_worlds import REPO, join, near, run_world, start_reference, stop

TOL = 1e-5
LR = 3e-4
CASES = (("llama3.2-1b", "prefill_32k"), ("llama3.2-1b", "decode_32k"),
         ("llama3.2-1b", "train_4k"), ("rwkv6-1.6b", "prefill_32k"))


# the reference's steps on a (2, 2) mesh of forced host devices, from
# argv[1]'s parameters and arguments, their outputs pickled to argv[2]
REF_SCRIPT = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
import repro.configs
import repro.models.base as base
from repro.launch import shardings, steps
from repro.models import hooks
with open(sys.argv[1], "rb") as f:
    ref = pickle.load(f)
shardings._BIG_LEAF = 0
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for (arch, shape), rest in ref["rest"].items():
    cfg = base.get_config(arch, smoke=True).replace(dtype="float32")
    base._REGISTRY[arch] = lambda smoke=False, c=cfg: c
    params = jax.tree.map(jnp.asarray, ref["params"][arch])
    rest = [jax.tree.map(jnp.asarray, r) for r in rest]
    case = steps.build_case(arch, shape, mesh)          # its hooks
    pspecs = shardings.param_specs(params, mesh)
    kind = repro.configs.INPUT_SHAPES[shape].kind
    if kind == "train":
        opt = steps.make_optimizer(arch, cfg).init(params)
        args = [params, opt, rest[0]]
        specs = [pspecs, shardings.opt_specs(opt, pspecs),
                 shardings.batch_specs(rest[0], mesh)]
    elif kind == "prefill":
        args = [params, rest[0]]
        specs = [pspecs, shardings.batch_specs(rest[0], mesh)]
    else:
        args = [params, *rest]
        specs = [pspecs, shardings.cache_specs(rest[0], mesh),
                 P("data", None), P("data")]
    with jax.set_mesh(mesh):
        res = jax.jit(case.step_fn,
                      in_shardings=shardings.named(mesh, tuple(specs)))(*args)
    hooks.clear()
    out[(arch, shape)] = jax.tree.map(np.asarray, res)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ref_inputs(path):
    """Pickle the reference's smoke parameters of each arch (seed 3, as
    numpy) and each case's other arguments (the port's ``mesh=None``
    case's, seed 0, as numpy; a train step's optimizer state is made from
    the parameters on each side) to ``path``."""
    import jax

    import repro.models.base as ref_base
    from repro.models import api as ref_api
    from repro_torch.launch import steps
    from torch_lm_mesh_world import CASES as WORLD_CASES
    from torch_lm_mesh_world import SEQ, _tree_np, smoke

    ref = {"params": {}, "rest": {}}
    for arch, shape, batch in WORLD_CASES:
        if arch not in ref["params"]:
            rcfg = ref_base.get_config(arch, smoke=True).replace(
                dtype="float32")
            ref["params"][arch] = jax.tree.map(
                np.asarray, ref_api.init_params(rcfg, jax.random.PRNGKey(3)))
        case = steps.build_case(arch, shape, device="cpu", seed=0,
                                batch=batch, cfg=smoke(arch), seq=SEQ)
        rest = case.args[2:] if case.kind == "train" else case.args[1:]
        ref["rest"][(arch, shape)] = [_tree_np(r) for r in rest]
    with open(path, "wb") as f:
        pickle.dump(ref, f)


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    """A folder with the reference's inputs (``ref_in.pkl``) and the
    reference's run on them started (its process, its deadline)."""
    tmp = tmp_path_factory.mktemp("lmworld")
    sys.path.insert(0, str(REPO / "tests"))
    _ref_inputs(tmp / "ref_in.pkl")
    proc, deadline = start_reference(REF_SCRIPT, tmp / "ref_in.pkl",
                                     tmp / "ref_out.pkl")
    yield tmp, proc, deadline
    stop(proc)


@pytest.fixture(scope="module")
def ranks(world_dir):
    """Each rank's pickled results (the world runs beside the
    reference's process)."""
    tmp, _, _ = world_dir
    return run_world("torch_lm_mesh_world.py", tmp, tmp / "ref_in.pkl")


@pytest.fixture(scope="module")
def reference(world_dir):
    """The reference's outputs of each case on its (2, 2) mesh."""
    tmp, proc, deadline = world_dir
    join([proc], deadline)
    with open(tmp / "ref_out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("arch, shape", [c for c in CASES
                                         if c[1] != "train_4k"])
def test_forward_steps_match_mesh_none(ranks, arch, shape):
    for r, got in enumerate(ranks):
        case = got[(arch, shape)]
        for i, (a, b) in enumerate(zip(case["mesh"]["out"],
                                       case["none"]["out"], strict=True)):
            for j, (x, y) in enumerate(zip(a, b, strict=True)):
                near(x, y, TOL, f"rank {r} output {i} leaf {j}")
        assert case["mesh"]["launches"] == (0, 0)


def test_train_step_matches_mesh_none(ranks):
    for r, got in enumerate(ranks):
        case = got[("llama3.2-1b", "train_4k")]
        (params, opt, metrics), (w_params, w_opt, w_metrics) = \
            case["mesh"]["out"], case["none"]["out"]
        n = len(w_params)
        assert len(opt) == len(w_opt) == 2 * n
        for x, y in zip(metrics, w_metrics, strict=True):
            near(x, y, TOL, f"rank {r} metrics")
        for j, (x, y) in enumerate(zip(opt, w_opt)):
            near(x, y, TOL, f"rank {r} moment leaf {j}")
        for g, w, m in zip(params, w_params, w_opt[:n], strict=True):
            big = np.abs(m / 0.1) > 1e-6                # m = (1 - b1) g
            np.testing.assert_allclose(g[big], w[big], rtol=TOL, atol=TOL)
            assert np.abs(g - w).max() <= 2 * LR


def test_every_rank_holds_the_same_whole_outputs(ranks):
    for arch, shape in CASES:
        first = ranks[0][(arch, shape)]["mesh"]["out"]
        for got in ranks[1:]:
            for a, b in zip(first, got[(arch, shape)]["mesh"]["out"]):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


def test_prefill_logits_stay_sharded(ranks):
    """The logits come out batch-sharded on 'data' (llama: a partial sum
    over 'model' of its tied head; rwkv: its untied head's vocabulary on
    'model')."""
    got = ranks[0]
    assert got[("llama3.2-1b", "prefill_32k")]["mesh"]["placements"][0] \
        == "S(0)"
    assert got[("rwkv6-1.6b", "prefill_32k")]["mesh"]["placements"][0] \
        == "S(0)"


@pytest.mark.parametrize("arch, shape", [c for c in CASES
                                         if c[1] != "train_4k"])
def test_forward_steps_on_a_mesh_match_the_reference(ranks, reference, arch,
                                                     shape):
    """Logits and the filled cache, every rank's whole outputs, against
    the reference's step on its (2, 2) mesh (integer leaves equal)."""
    import jax

    want = jax.tree.leaves(reference[(arch, shape)])
    for r, got in enumerate(ranks):
        leaves = jax.tree.leaves(got[(arch, shape)]["ref_mesh"])
        assert len(leaves) == len(want)
        for j, (x, y) in enumerate(zip(leaves, want)):
            if np.issubdtype(y.dtype, np.integer):
                np.testing.assert_array_equal(x, y, f"rank {r} leaf {j}")
            else:
                near(np.asarray(x, np.float32), y, TOL,
                     f"rank {r} leaf {j}")


def test_train_step_on_a_mesh_matches_the_reference(ranks, reference):
    """One AdamW step on the mesh against the reference's on its (2, 2)
    mesh: the metrics and both moments within 1e-5 of each leaf's
    largest value, the parameters by ``test_torch_steps``' rule."""
    import jax

    w_params, w_opt, w_metrics = reference[("llama3.2-1b", "train_4k")]
    for r, got in enumerate(ranks):
        params, opt, metrics = got[("llama3.2-1b", "train_4k")]["ref_mesh"]
        for name in ("ce", "aux", "acc"):
            near(np.asarray(metrics[name]), np.asarray(w_metrics[name]),
                 TOL, f"rank {r} {name}")
        assert int(opt["count"]) == int(w_opt["count"]) == 1
        for slot in ("m", "v"):
            got_l, want_l = (jax.tree.leaves(t[slot]) for t in (opt, w_opt))
            assert len(got_l) == len(want_l)
            for j, (x, y) in enumerate(zip(got_l, want_l)):
                near(x, y, TOL, f"rank {r} {slot} leaf {j}")
        for g, w, m in zip(jax.tree.leaves(params), jax.tree.leaves(w_params),
                           jax.tree.leaves(w_opt["m"]), strict=True):
            big = np.abs(m / 0.1) > 1e-6                # m = (1 - b1) g
            np.testing.assert_allclose(g[big], w[big], rtol=TOL, atol=TOL)
            assert np.abs(g - w).max() <= 2 * LR


@pytest.mark.parametrize("arch, shape", CASES + (("rwkv6-1.6b", "train_4k"),))
def test_mesh_1x1_is_mesh_none_bit_for_bit(arch, shape):
    """On a one-rank gloo group in this process (started by the mesh,
    taken down after), the step on ``make_debug_mesh((1, 1))`` is the
    ``mesh=None`` step bit for bit."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "tests"))
    from torch_lm_mesh_world import SEQ, _whole, smoke

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    had = dist.is_initialized()
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"), device="cpu")
        kw = dict(batch=2, seq=SEQ, cfg=smoke(arch), seed=0, device="cpu")
        plain = steps.build_case(arch, shape, **kw)
        want = [_whole(part) for part in plain.step_fn(*plain.args)]
        case = steps.build_case(arch, shape, mesh=mesh, **kw)
        got = [_whole(part) for part in case.step_fn(*case.args)]
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()
    for a, b in zip(got, want, strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)


def _arch_ids():
    import repro_torch.configs  # noqa: F401  (registry)
    from repro_torch.models.base import list_archs
    return list_archs()


@pytest.mark.parametrize("arch", _arch_ids())
def test_params_on_a_mesh_are_init_params_shards(arch, monkeypatch):
    """``steps.init_params_on_mesh`` on rank 0 of a fake (data 2, model 2)
    world, every leaf FSDP-sharded where a dim divides (the size floor
    lowered to 0): each leaf is rank 0's shard of ``api.init_params``'
    draw from the same seed, laid out by ``param_specs``."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import shardings, steps
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    from repro_torch.models import api
    from repro_torch.models.base import get_config
    from repro_torch.tree import tree_leaves

    monkeypatch.setattr(shardings, "_BIG_LEAF", 0)
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    whole = api.init_params(cfg, torch.Generator().manual_seed(0))
    with fake_world(4):
        mesh = make_debug_mesh((2, 2), ("data", "model"), device="cpu")
        got = steps.init_params_on_mesh(
            cfg, torch.Generator().manual_seed(0), mesh)
        specs = shardings.param_specs(whole, mesh)
        for g, w, spec in zip(tree_leaves(got), tree_leaves(whole),
                              tree_leaves(specs), strict=True):
            pl = shardings.placements(spec, mesh)
            assert tuple(g.placements) == pl
            assert g.shape == w.shape and g.stride() == w.stride()
            ref = distribute_tensor(w, mesh, pl, src_data_rank=None)
            assert torch.equal(g.to_local(), ref.to_local())
