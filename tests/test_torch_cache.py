"""The port's engine cache (``core/cache.py``) on the CPU: the key's
fields, hits and misses, a flat ``compile_count`` on a cell's second run,
LRU eviction around pinned entries, evaluators shared per (cfg, batch,
eval-split fingerprint, device), the fingerprint against the reference's,
and a first run's result untouched by a second run through the same
entry (whose static buffers it overwrites)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.cache import data_fingerprint as ref_data_fingerprint
from repro_torch.configs import facade_paper
from repro_torch.core import runner
from repro_torch.core.cache import (EngineCache, EngineSpec,
                                    data_fingerprint)
from repro_torch.data import synthetic
from repro_torch.netsim import NetworkConfig
from repro_torch.obs import ObsConfig
from repro_torch.topo import TopoConfig
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
CFG = facade_paper.lenet(smoke=True).replace(n_classes=4)
KW = dict(rounds=4, k=2, degree=2, local_steps=2, batch_size=4, lr=0.05,
          eval_every=2, device="cpu")
SPEC = EngineSpec(algo="facade", cfg=CFG, n=4, k=2, degree=2,
                  local_steps=2, batch_size=4, lr=0.05,
                  device=torch.device("cpu"))
# one other value per field: each must give another key
PERTURB = {"algo": "el", "cfg": CFG.replace(width=CFG.width + 1), "n": 5,
           "k": 3, "degree": 3, "local_steps": 3, "batch_size": 8,
           "lr": 0.01, "warmup_rounds": 2, "head_jitter": 0.1,
           "eval_batch": 128, "device": torch.device("cuda"),
           "net": NetworkConfig.preset("edge-churn"),
           "topo": TopoConfig(policy="reliability"), "obs": ObsConfig(),
           "mesh": (2,)}


def _data(seed=3, test_per_class=8):
    spec = synthetic.SynthSpec(n_classes=4, image_size=16,
                               samples_per_class=8,
                               test_per_class=test_per_class, seed=seed)
    return synthetic.make_clustered_data(spec, (3, 1), ("rot0", "rot180"))


@pytest.fixture(scope="module")
def ds():
    return _data()


def test_every_field_is_perturbed():
    assert set(PERTURB) == {f.name for f in dataclasses.fields(EngineSpec)}


@pytest.mark.parametrize("field", sorted(PERTURB))
def test_every_spec_field_forks_the_key(field):
    other = dataclasses.replace(SPEC, **{field: PERTURB[field]})
    assert other != SPEC and hash(other) != hash(SPEC)
    cache = EngineCache()
    cache._entries[SPEC] = object()        # a stand-in: no entry is built
    assert SPEC in cache and other not in cache
    assert dataclasses.replace(SPEC) == SPEC


def test_hits_and_misses():
    cache = EngineCache()
    a = cache.entry(SPEC)
    assert (cache.hits, cache.misses, len(cache)) == (0, 1, 1)
    assert cache.entry(SPEC) is a
    b = cache.entry(dataclasses.replace(SPEC, algo="el"))
    assert b is not a and (cache.hits, cache.misses, len(cache)) == (1, 2, 2)
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 2,
                             "evictions": 0, "compiles": 0,
                             "evaluator_builds": 0, "max_entries": None}


@pytest.mark.parametrize("algo", ["facade", "dac"])
def test_compile_count_is_flat_on_a_cells_second_run(ds, algo):
    cache = EngineCache()
    kw = dict(KW, warmup_rounds=1) if algo == "facade" else KW
    runner.run_experiment(algo, CFG, ds, cache=cache, seed=0, **kw)
    first = cache.compile_count
    assert first == (2 if algo == "facade" else 1) + 1   # + the evaluator
    runner.run_experiment(algo, CFG, ds, cache=cache, seed=1,
                          **dict(kw, rounds=5, eval_every=3))
    assert cache.compile_count == first
    assert (cache.hits, cache.misses, cache.evaluator_builds) == (1, 1, 1)
    assert not cache.pinned(next(iter(cache._entries)))


def test_lru_eviction_never_drops_a_pinned_entry():
    cache = EngineCache(max_entries=2)
    specs = [dataclasses.replace(SPEC, n=m) for m in (4, 5, 6, 7)]
    cache.entry(specs[0])
    with cache.pin(specs[0]):
        assert cache.pinned(specs[0])
        cache.entry(specs[1])
        cache.entry(specs[2])              # evicts specs[1], the oldest
        assert specs[0] in cache and specs[1] not in cache
        with cache.pin(specs[2]):
            cache.entry(specs[3])          # both others pinned: overshoot
            assert len(cache) == 3 and cache.evictions == 1
    assert not cache.pinned(specs[0])
    cache.entry(specs[3])                  # bound restored, LRU first
    assert len(cache) == 2 and specs[0] not in cache
    assert cache.evictions == 2
    with pytest.raises(ValueError, match="max_entries"):
        EngineCache(max_entries=0)


def test_evaluators_are_shared_and_a_changed_eval_split_builds_one(ds):
    cache = EngineCache()
    entry = cache.entry(SPEC)
    ev = cache.evaluator(entry.binding, ds, batch=16, device="cpu")
    other = cache.entry(dataclasses.replace(SPEC, algo="dpsgd"))
    assert cache.evaluator(other.binding, ds, batch=16, device="cpu") is ev
    assert cache.evaluator_builds == 1
    assert cache.evaluator(entry.binding, ds, batch=8,
                           device="cpu") is not ev
    changed = _data(test_per_class=4)
    assert data_fingerprint(changed) != data_fingerprint(ds)
    assert cache.evaluator(entry.binding, changed, batch=16,
                           device="cpu") is not ev
    assert cache.evaluator_builds == 3
    assert cache.compile_count == 3


@pytest.mark.parametrize("seed", [3, 4])
def test_data_fingerprint_equals_the_references(seed):
    data = _data(seed=seed)
    assert data_fingerprint(data) == ref_data_fingerprint(data)


def test_a_second_run_leaves_the_first_runs_result_as_it_was(ds):
    cache = EngineCache()
    kw = dict(KW, head_jitter=0.05)
    first = runner.run_experiment("facade", CFG, ds, cache=cache, seed=0,
                                  **kw)
    models = [l.clone() for l in tree_leaves(first.models)]
    history = [(r, c.copy()) for r, c in first.cluster_history]
    second = runner.run_experiment("facade", CFG, ds, cache=cache, seed=1,
                                   **kw)
    assert cache.hits == 1
    assert all(torch.equal(a, b)
               for a, b in zip(models, tree_leaves(first.models)))
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(first.models), tree_leaves(second.models)))
    for (r1, c1), (r2, c2) in zip(history, first.cluster_history):
        assert r1 == r2
        np.testing.assert_array_equal(c1, c2)
