"""The hybrid, MoE, MLA, VLM and audio families' steps on a mesh of four
gloo ranks on the CPU: the smoke prefill and decode (fp32, S 16) of
hymba-1.5b, deepseek-moe-16b, minicpm3-4b, llava-next-34b (S 32: its 16
image embeddings in front of 16 tokens) and whisper-tiny (with its 32
frames), built by ``launch.steps.build_case(mesh=...)`` on a (data 2,
model 2) debug mesh, each rank of ``tests/torch_lm_mesh_families_world.py``
running them; one spawn of four processes.

Where the port's layouts depart from GSPMD's: a hymba variant with
full-width hymba's shape of heads cut to 5 query heads over 1 kv head
(``hymba-1.5b-h5``, registered on both sides), neither of which divides
the model axis of 2 (K2 gathers q along S; ``split_last``/``merge_last``
gather the heads), and on a (data 1, model 4) mesh of the same world
hymba's and llava's smoke configs, whose 2 kv heads do not divide 4, and
deepseek-moe-16b's dispatch in one group (two on (2, 2)).

Each step is held against ``mesh=None`` from the same seed, and, from
the reference's parameters (``repro.models.api.init_params``, carried
across by ``interop.lm_params_from_jax``) and the port's other arguments,
against the reference's step (``repro.launch.steps.build_case``) on the
same mesh of four forced host devices, jitted with its ``in_shardings``
and activation hooks in a subprocess that runs beside the world; every
leaf that a dim of divides FSDP-sharded on both sides (the size floor
lowered to 0). Outputs within 1e-5 of each leaf's largest value (the
tolerance of ``tests/test_torch_lm_mesh.py``; the gaps read at most
1.2e-6 against ``mesh=None`` and 1.4e-6 against the reference), integer
leaves equal."""
from __future__ import annotations

import dataclasses
import pickle
import sys

import numpy as np
import pytest

from torch_worlds import REPO, join, near, run_world, start_reference, stop

sys.path.insert(0, str(REPO / "tests"))
import torch_lm_mesh_families_world as fw  # noqa: E402

TOL = 1e-5

# the reference's parameters of each config in argv[1] (seed 3), pickled
# as numpy to argv[3] for the world, then its steps on each case's mesh of
# forced host devices from them and the port's other arguments, outputs
# pickled to argv[2]
REF_SCRIPT = """
import os, pickle, sys
# LLVM's passes off: compiling, not running, is what takes this script's
# time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
import repro.configs
import repro.models.base as base
from repro.launch import shardings, steps
from repro.models import api, hooks
with open(sys.argv[1], "rb") as f:
    ref = pickle.load(f)
shardings._BIG_LEAF = 0
params = {}
for name, fields in ref["cfgs"].items():
    cfg = base.ModelConfig(**fields)
    base._REGISTRY[name] = lambda smoke=False, c=cfg: c
    params[name] = jax.tree.map(np.asarray, jax.jit(
        lambda key, c=cfg: api.init_params(c, key))(jax.random.PRNGKey(3)))
with open(sys.argv[3] + ".part", "wb") as f:
    pickle.dump(params, f)
os.replace(sys.argv[3] + ".part", sys.argv[3])
out = {}
for name, shape, mesh_shape in ref["cases"]:
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(mesh_shape),
                ("data", "model"))
    rest = [jax.tree.map(jnp.asarray, r) for r in ref["rest"][(name, shape)]]
    case = steps.build_case(name, shape, mesh)          # its hooks
    pspecs = shardings.param_specs(params[name], mesh)
    if shape == "prefill_32k":
        specs = [pspecs, shardings.batch_specs(rest[0], mesh)]
    else:
        specs = [pspecs, shardings.cache_specs(rest[0], mesh),
                 P("data", None), P("data")]
    with jax.set_mesh(mesh):
        res = jax.jit(case.step_fn, in_shardings=shardings.named(
            mesh, tuple(specs)))(params[name], *rest)
    hooks.clear()
    out[(name, shape, mesh_shape)] = jax.tree.map(np.asarray, res)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ref_inputs(path):
    """Pickle each config (its fields), each (config, shape)'s arguments
    but the parameters (the port's ``mesh=None`` case's, seed 0, as numpy)
    and the cases."""
    from torch_lm_mesh_world import _tree_np

    ref = {"cfgs": {}, "rest": {}, "cases": fw.CASES}
    for name, shape, _ in fw.CASES:
        ref["cfgs"].setdefault(name, dataclasses.asdict(fw.config(name)))
        if (name, shape) not in ref["rest"]:
            case = fw.build(name, shape)
            ref["rest"][(name, shape)] = [_tree_np(r) for r in case.args[1:]]
    with open(path, "wb") as f:
        pickle.dump(ref, f)


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    """A folder with the reference's inputs and the reference's run on
    them started (its process, its deadline)."""
    tmp = tmp_path_factory.mktemp("famworld")
    _ref_inputs(tmp / "ref_in.pkl")
    proc, deadline = start_reference(REF_SCRIPT, tmp / "ref_in.pkl",
                                     tmp / "ref_out.pkl",
                                     tmp / "ref_params.pkl")
    yield tmp, proc, deadline
    stop(proc)


@pytest.fixture(scope="module")
def ranks(world_dir):
    tmp, _, _ = world_dir
    return run_world("torch_lm_mesh_families_world.py", tmp,
                     tmp / "ref_params.pkl")


@pytest.fixture(scope="module")
def reference(world_dir):
    tmp, proc, deadline = world_dir
    join([proc], deadline)
    with open(tmp / "ref_out.pkl", "rb") as f:
        return pickle.load(f)


def test_the_cases_cover_heads_that_do_not_divide_the_model_axis():
    """The variant's query and kv heads do not divide a model axis of 2,
    hymba's and llava's kv heads not one of 4; the variant keeps hymba's
    ratio of query heads to kv heads at full width (25 over 5)."""
    full = fw.get_config("hymba-1.5b")
    h5 = fw.config("hymba-1.5b-h5")
    assert h5.n_heads % 2 and h5.n_kv_heads % 2
    assert h5.n_heads // h5.n_kv_heads == full.n_heads // full.n_kv_heads
    for name in ("hymba-1.5b", "llava-next-34b"):
        cfg = fw.config(name)
        assert cfg.n_heads % 4 == 0 and cfg.n_kv_heads % 4
        assert (name, "prefill_32k", (1, 4)) in fw.CASES
    assert ("hymba-1.5b-h5", "prefill_32k", (2, 2)) in fw.CASES
    assert fw.config("llava-next-34b").n_image_tokens + fw.SEQ == \
        fw.seq_of("llava-next-34b")


@pytest.mark.parametrize("name, shape, mesh", fw.CASES)
def test_step_on_a_mesh_matches_mesh_none(ranks, name, shape, mesh):
    for r, got in enumerate(ranks):
        case, want = got[(name, shape, mesh)]["mesh"], got[(name, shape)]
        assert len(case["out"]) == len(want["out"])
        for i, (a, b) in enumerate(zip(case["out"], want["out"])):
            assert len(a) == len(b)
            for j, (x, y) in enumerate(zip(a, b)):
                near(x, y, TOL, f"rank {r} output {i} leaf {j}")
        assert case["launches"] == 0


@pytest.mark.parametrize("name, shape, mesh", fw.CASES)
def test_step_on_a_mesh_matches_the_reference(ranks, reference, name, shape,
                                              mesh):
    """Every rank's whole outputs (logits and the filled cache, whisper's
    encoder states) against the reference's on the same mesh."""
    import jax

    want = jax.tree.leaves(reference[(name, shape, mesh)])
    for r, got in enumerate(ranks):
        leaves = jax.tree.leaves(got[(name, shape, mesh)]["ref_mesh"])
        assert len(leaves) == len(want)
        for j, (x, y) in enumerate(zip(leaves, want)):
            near(x, y, TOL, f"rank {r} leaf {j}")


def test_every_rank_holds_the_same_whole_outputs(ranks):
    for key in fw.CASES:
        first = ranks[0][key]["mesh"]["out"]
        for got in ranks[1:]:
            for a, b in zip(first, got[key]["mesh"]["out"], strict=True):
                for x, y in zip(a, b, strict=True):
                    np.testing.assert_array_equal(x, y)
