"""The port's examples (``examples/torch_*.py``) against the JAX reference
on the CPU, at a few rounds; the reference's example scripts themselves
are not run (they take minutes), their settings and loops are replayed.

* quickstart: the port's ``run`` through ``torch_caps.JaxDraws`` against
  the reference's ``run_experiment`` with the same settings (4 rounds,
  eval every 2). Bytes exact, accuracies within 0.1 (the reference's own
  precedent across layouts, ``tests/test_mesh.py``). Cluster ids are
  compared only with ``head_jitter > 0``: at the example's
  ``head_jitter`` 0 the two heads are equal, so round one's selections
  are last-ulp ties that the two frameworks may break differently.
* serve_batched: the reference example's state (``PRNGKey(0)``), carried
  across by ``interop.lm_params_from_jax``, and its per-cluster greedy
  loop at the smoke size; the generated tokens equal.
* facade_lm_pretrain: 2 rounds from the reference's numpy batch indices
  and its topology keys; cluster ids equal, and the per-cluster NLL of
  ``evaluate`` within 1e-5 of the reference example's ``evaluate``.
* fairness_eval, obs_demo (the report re-rendered by ``python -m
  repro_torch.obs.report``) and netsim_demo (its per-tier split on the
  reference's ``node_tiers``): what each prints equals its results.
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
from repro.configs import facade_paper as ref_configs
from repro.core import facade as ref_facade
from repro.core import runner as ref_runner
from repro.core import split as ref_split
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_facade_state as ref_init_facade
from repro.data import synthetic as ref_synthetic
from repro.data import tokens as ref_tokens
from repro.fairness.metrics import fair_accuracy as ref_fair_accuracy
from repro.models import transformer as ref_tf
from repro.models.base import get_config as ref_get_config
from repro.netsim import NetworkConfig as RefNetworkConfig
from repro.netsim import node_tiers as ref_node_tiers
from repro.obs.report import build_report as ref_build_report
from torch_caps import JaxDraws

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "fairness_eval", "obs_demo", "netsim_demo",
            "serve_batched", "facade_lm_pretrain")
TOL = 0.1
NLL_TOL = 1e-5
ID_BYTES = 4          # the cluster id FACADE pushes beside its model
FEW = dict(rounds=4, eval_every=2)
# half a unit of the last printed digit: accuracies to 3 decimals, MB to
# 1, hours to 2
ROW_TOL = (5e-4, 5e-4, 5e-4, 5e-2, 5e-3)


def _load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def example(name: str):
    """``examples/torch_<name>.py`` as a module."""
    return _load(REPO / "examples" / f"torch_{name}.py")


class ExampleDraws(JaxDraws):
    """The reference LM examples' draws: the state from
    ``init_facade_state(binding, PRNGKey(0), ...)`` itself (not from a
    split of it, as the runner's), its topology keys from that state's."""

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self._k_init = jax.random.PRNGKey(seed)


def _numbers(line: str) -> list:
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+", line)]


def _line(text: str, start: str) -> str:
    return next(l for l in text.splitlines() if l.startswith(start))


# ----------------------------------------------------------- quickstart --
@pytest.mark.parametrize("head_jitter", [0.0, 0.05])
def test_quickstart_matches_the_reference(head_jitter):
    ex = example("quickstart")
    got = ex.run(head_jitter=head_jitter, verbose=False, device="cpu",
                 draws=JaxDraws, **FEW)
    spec = ref_synthetic.SynthSpec(n_classes=4, image_size=16,
                                   samples_per_class=16, test_per_class=32,
                                   seed=3)
    ds = ref_synthetic.make_clustered_data(spec, (6, 2), ("rot0", "rot180"))
    np.testing.assert_array_equal(got["dataset"].train_x, ds.train_x)
    rcfg = ref_configs.lenet(smoke=True).replace(n_classes=4)
    # EL has no heads: the jittered case holds FACADE alone
    for algo in ("el", "facade") if head_jitter == 0 else ("facade",):
        want = ref_runner.run_experiment(
            algo, rcfg, ds, rounds=FEW["rounds"], k=2, degree=2,
            local_steps=4, batch_size=8, lr=0.05,
            eval_every=FEW["eval_every"], seed=0, head_jitter=head_jitter,
            engine=False)
        res = got[algo]
        assert res.comm.bytes == want.comm.bytes                  # exact
        for (r, a), (q, b) in zip(res.acc_per_cluster,
                                  want.acc_per_cluster, strict=True):
            assert r == q
            np.testing.assert_allclose(a, b, atol=TOL)
        np.testing.assert_allclose(res.final_acc, want.final_acc, atol=TOL)
        assert abs(res.best_fair_acc() - want.best_fair_acc()) <= TOL
        if algo == "facade" and head_jitter > 0:
            for (r, c), (q, d) in zip(res.cluster_history,
                                      want.cluster_history, strict=True):
                assert r == q
                np.testing.assert_array_equal(c, np.asarray(d))
    if head_jitter > 0:
        return
    text = ex.summary(got)
    el, fa = got["el"], got["facade"]
    assert _numbers(_line(text, "EL ")) == pytest.approx(
        [el.final_acc[0], el.final_acc[1], el.best_fair_acc()], abs=5e-4)
    assert _numbers(_line(text, "FACADE")) == pytest.approx(
        [fa.final_acc[0], fa.final_acc[1], fa.best_fair_acc()], abs=5e-4)
    assert f"EL: {el.comm.bytes[0]:.0f}   FACADE: {fa.comm.bytes[0]:.0f}" \
        in text
    # the same model bytes a push: FACADE's push adds its 4-byte cluster id
    assert fa.comm.bytes[0] - el.comm.bytes[0] == ID_BYTES * 8 * 2
    assert str(fa.cluster_history[-1][1].tolist()) in text


# -------------------------------------------------------- serve_batched --
def _reference_serve(n_requests=8, prompt_len=32, gen_len=16, k=2):
    """``examples/serve_batched.py``'s state and per-cluster loop."""
    cfg = ref_get_config("llama3.2-1b", smoke=True)
    state = ref_init_facade(ref_make_binding(cfg), jax.random.PRNGKey(0),
                            4, k, head_jitter=0.05)
    state = state._replace(cluster_id=jnp.asarray([0, 0, 1, 1], jnp.int32))
    models = []
    for c in range(k):
        node = int(np.argmax(np.asarray(state.cluster_id) == c))
        core = jax.tree.map(lambda l: l[node], state.cores)
        head = ref_split.select_head(
            jax.tree.map(lambda l: l[node], state.heads), jnp.int32(c))
        models.append(ref_split.merge_params(core, head))
    rng = np.random.default_rng(0)
    requests = [(int(rng.integers(0, k)),
                 rng.integers(1, cfg.vocab_size, size=prompt_len)
                 .astype(np.int32)) for _ in range(n_requests)]
    prefill = jax.jit(lambda p, t: ref_tf.prefill(cfg, p, t,
                                                  cache_extra=gen_len))
    decode = jax.jit(lambda p, c, t, pos: ref_tf.decode_step(cfg, p, c, t,
                                                             pos))
    out = {}
    for c in range(k):
        batch = [t for cc, t in requests if cc == c]
        if not batch:
            continue
        logits, cache = prefill(models[c], jnp.asarray(np.stack(batch)))
        last = jnp.argmax(logits, -1).astype(jnp.int32)
        outs = [np.asarray(last)]
        pos = jnp.full((len(batch),), prompt_len, jnp.int32)
        for _ in range(gen_len - 1):
            logits, cache = decode(models[c], cache, last[:, None], pos)
            last = jnp.argmax(logits, -1).astype(jnp.int32)
            outs.append(np.asarray(last))
            pos = pos + 1
        out[c] = np.stack(outs, axis=1)
    return requests, out


def test_serve_batched_generates_the_reference_tokens():
    got = example("serve_batched").run(device="cpu", draws=ExampleDraws)
    requests, want = _reference_serve()
    assert [c for c, _ in got["requests"]] == [c for c, _ in requests]
    for (_, a), (_, b) in zip(got["requests"], requests):
        np.testing.assert_array_equal(a, b)
    assert sorted(got["generated"]) == sorted(want)
    for c, toks in want.items():
        np.testing.assert_array_equal(got["generated"][c].numpy(), toks)
    text = example("serve_batched").summary(got)
    for c, toks in want.items():
        assert (f"cluster {c}: served {toks.shape[0]} requests; generated "
                f"[{toks.shape[0]}, 16] tokens; first: "
                f"{toks[0, :8].tolist()}") in text


# --------------------------------------------------- facade_lm_pretrain --
def _reference_pretrain(rounds, nodes=(3, 1), seq=64, batch=4,
                        local_steps=2, lr=5e-3):
    """``examples/facade_lm_pretrain.py``'s loop for ``rounds`` rounds,
    evaluating after each with the example's own ``evaluate``."""
    ref_ex = _load(REPO / "examples" / "facade_lm_pretrain.py")
    cfg = ref_get_config("llama3.2-1b", smoke=True)
    binding = ref_make_binding(cfg)
    # the example's evaluate with its loss jitted (the same values as
    # eagerly, in a tenth of the time)
    eval_binding = binding._replace(loss=jax.jit(binding.loss))
    n, k = sum(nodes), len(nodes)
    data = ref_tokens.make_clustered_tokens(
        ref_tokens.TokenSpec(vocab_size=cfg.vocab_size, seq_len=seq + 1,
                             seed=0), nodes,
        seqs_per_node=rounds * local_steps * batch // 4)
    train = data["train"]
    fcfg = ref_facade.FacadeConfig(n_nodes=n, k=k, degree=min(2, n - 1),
                                   local_steps=local_steps, lr=lr,
                                   head_jitter=1e-3)
    state = ref_init_facade(binding, jax.random.PRNGKey(0), n, k,
                            head_jitter=1e-3)
    round_fn = jax.jit(functools.partial(ref_facade.facade_round, fcfg,
                                         binding))
    rng = np.random.default_rng(0)
    evals = []
    for _ in range(rounds):
        idx = rng.integers(0, train.shape[1], size=(n, local_steps, batch))
        rows = train[np.arange(n)[:, None, None], idx]
        b = {kk: jnp.asarray(vv)
             for kk, vv in ref_tokens.lm_batch(rows).items()}
        state, _ = round_fn(state, b)
        evals.append((ref_ex.evaluate(eval_binding, state, data, seq),
                      np.asarray(state.cluster_id)))
    return evals


def test_facade_lm_pretrain_matches_the_reference():
    ex = example("facade_lm_pretrain")
    got = ex.run(rounds=2, eval_every=1, verbose=False, device="cpu",
                 draws=ExampleDraws)
    want = _reference_pretrain(2)
    assert [r for r, *_ in got["evals"]] == [1, 2]
    for (_, nll, cid, _), (ref_nll, ref_cid) in zip(got["evals"], want,
                                                     strict=True):
        np.testing.assert_array_equal(cid.numpy(), ref_cid)
        np.testing.assert_allclose(nll, ref_nll, rtol=0, atol=NLL_TOL)
    text = ex.summary(got)
    assert (f"final head assignment: "
            f"{got['state'].cluster_id.tolist()}") in text
    assert f"{got['node_cluster'].tolist()}" in _line(text, "true clusters")


# ------------------------------------------------------------- the rest --
def test_fairness_eval_prints_its_results():
    ex = example("fairness_eval")
    out = ex.run(device="cpu", **FEW)
    el, fa = out["el"], out["facade"]
    text = ex.summary(out)
    rows = {"accuracy majority cluster": (el.final_acc[0], fa.final_acc[0]),
            "accuracy minority cluster": (el.final_acc[1], fa.final_acc[1])}
    for label, want in rows.items():
        assert _numbers(_line(text, label)) == pytest.approx(want, abs=5e-4)
    assert _numbers(_line(text, "demographic parity")) == pytest.approx(
        (el.dp, fa.dp), abs=5e-5)
    assert _numbers(_line(text, "equalized odds")) == pytest.approx(
        (el.eo, fa.eo), abs=5e-5)
    lines = [l for l in text.splitlines() if l.startswith("fair accuracy")]
    assert len(lines) == len(ex.LAMBDAS)
    for line, lam, fe, ff in zip(lines, ex.LAMBDAS, out["fair_acc"]["el"],
                                 out["fair_acc"]["facade"]):
        # Eq. 5 as the reference computes it, on the run's accuracies
        assert fe == ref_fair_accuracy(el.final_acc, lam=lam)
        assert ff == ref_fair_accuracy(fa.final_acc, lam=lam)
        printed_lam, *printed = _numbers(line)
        assert printed_lam == pytest.approx(lam, abs=5e-3)
        assert printed == pytest.approx([fe, ff], abs=5e-4)
    gap = _numbers(_line(text, "cluster accuracy gap"))
    assert gap == pytest.approx([el.final_acc[0] - el.final_acc[1],
                                 fa.final_acc[0] - fa.final_acc[1]],
                                abs=5e-4)


# runpy warns that the module it runs as __main__ was imported before
@pytest.mark.filterwarnings(
    "ignore:'repro_torch.obs.report' found in sys.modules:RuntimeWarning")
def test_obs_demo_prints_its_results_and_the_report_rerenders(tmp_path,
                                                               capsys):
    ex = example("obs_demo")
    out = ex.run(out_dir=tmp_path, rounds=8, eval_every=2, warmup_rounds=2,
                 device="cpu")
    res, table = out["result"], out["eval_table"]
    assert res.eval_frames[-1].dp == res.dp
    text = ex.summary(out)
    rows = [l for l in text.splitlines() if l.startswith("  round")]
    assert len(rows) == len(table["round"]) == len(res.eval_frames)
    for row, frame in zip(rows, res.eval_frames):
        rnd, dp, eo, worst, churn = re.fullmatch(
            r"  round +(\d+): dp=(\S+) eo=(\S+) worst_cluster=(\S+) "
            r"churn=(\S+)", row).groups()
        assert int(rnd) == frame.round
        assert float(dp) == pytest.approx(frame.dp, abs=5e-4)
        assert float(eo) == pytest.approx(frame.eo, abs=5e-4)
        assert float(worst) == pytest.approx(frame.worst_cluster_acc,
                                             abs=5e-4)
        assert float(churn) == pytest.approx(frame.cluster_churn, abs=0.5)
    health = out["manifest"].health
    assert f"health verdict: {health['verdict']}" in text
    path = out["manifest_path"]
    assert path.parent == tmp_path and path.exists()
    assert out["markdown"] in text
    assert f"python -m repro_torch.obs.report {path}" in text
    # the reference renders the port's manifest and trace to the same text
    assert ref_build_report(path)[1] == out["markdown"]
    # ``python -m repro_torch.obs.report PATH``, in this process
    capsys.readouterr()
    with pytest.raises(SystemExit) as done:
        argv, sys.argv = sys.argv, ["report", str(path)]
        try:
            runpy.run_module("repro_torch.obs.report", run_name="__main__")
        finally:
            sys.argv = argv
    assert done.value.code == 0
    assert capsys.readouterr().out == out["markdown"]


def test_netsim_demo_splits_on_the_reference_tiers():
    ex = example("netsim_demo")
    out = ex.run(device="cpu", draws=JaxDraws, **FEW)
    base = RefNetworkConfig.preset("edge-v2")
    want = np.asarray(ref_node_tiers(base, 8))
    text = ex.summary(out)
    assert set(out["scenarios"]) == set(ex.scenarios())
    for name, res in out["scenarios"].items():
        i = text.splitlines().index(next(l for l in text.splitlines()
                                         if l.startswith(f"{name} ")))
        row, choice = text.splitlines()[i:i + 2]
        want_row = [res.final_acc[0], res.final_acc[1], res.best_fair_acc(),
                    res.comm.bytes[-1] / 1e6, res.comm.seconds[-1] / 3600]
        for g, w, tol in zip(_numbers(row), want_row, ROW_TOL, strict=True):
            assert g == pytest.approx(w, abs=tol), (name, row)
        assert choice.endswith(str(res.cluster_history[-1][1].tolist()))
    for label, (res, tiers) in out["hostile"].items():
        np.testing.assert_array_equal(tiers, want)
        acc = np.asarray(res.node_acc, float)
        got = _numbers(_line(text, f"{label} "))
        assert got == pytest.approx(
            [res.best_fair_acc(), ex.tier_mean(acc, want, 0),
             ex.tier_mean(acc, want, 1)], abs=5e-4, nan_ok=True)
    assert all(np.isfinite(np.asarray(out["hostile"]["robust"][0].node_acc,
                                      float)))


# --------------------------------------------------------- entry points --
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_card_by_default_and_raises_without_one(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example(name).main([])


def test_serve_batched_main_runs_on_the_cpu(capsys):
    assert example("serve_batched").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("requests; generated") == 2
    assert "all requests served" in out


def test_examples_keep_the_reference_flags():
    """The LM pretraining example parses the reference's flags (and
    ``--device``); no example adds another."""
    flags = {}
    for name in EXAMPLES:
        for which, path in (("port", REPO / "examples" / f"torch_{name}.py"),
                            ("ref", REPO / "examples" / f"{name}.py")):
            flags[which, name] = set(re.findall(
                r"add_argument\(\"(--[\w-]+)\"", path.read_text()))
        assert flags["port", name] == flags["ref", name] | {"--device"}
    assert flags["ref", "facade_lm_pretrain"] == {
        "--arch", "--rounds", "--nodes", "--seq", "--batch",
        "--local-steps", "--lr", "--eval-every"}
