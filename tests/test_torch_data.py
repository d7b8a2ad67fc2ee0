"""The port's data path against the reference: synthetic data is
byte-identical, and batch gathering and eval batching agree exactly."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro.data import synthetic as ref_synthetic
from repro_torch.data import pipeline, synthetic

torch.set_num_threads(1)

QUICKSTART = dict(spec=dict(n_classes=4, image_size=16, samples_per_class=16,
                            test_per_class=32, seed=3),
                  sizes=(6, 2), transforms=("rot0", "rot180"), split=None)
CASES = {
    "quickstart": QUICKSTART,
    "paper_24_8": dict(spec=dict(n_classes=10, image_size=32,
                                 samples_per_class=2, test_per_class=3,
                                 seed=3),
                       sizes=(24, 8), transforms=("rot0", "rot180"),
                       split=None),
    "label_split": dict(spec=dict(n_classes=6, image_size=16,
                                  samples_per_class=5, test_per_class=4,
                                  seed=7),
                        sizes=(3, 2), transforms=("none", "gray"),
                        split=((0, 1, 2), (3, 4, 5))),
    "color_filters": dict(spec=dict(n_classes=3, image_size=8,
                                    samples_per_class=4, test_per_class=2,
                                    seed=1),
                          sizes=(1, 1, 1),
                          transforms=("sepia", "saturate", "rot90"),
                          split=None),
}


def _make(mod, case):
    return mod.make_clustered_data(mod.SynthSpec(**case["spec"]),
                                   case["sizes"], case["transforms"],
                                   label_split=case["split"])


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_synthetic_data_is_byte_identical(name):
    ref, port = _make(ref_synthetic, CASES[name]), _make(synthetic,
                                                         CASES[name])
    for field in ("train_x", "train_y", "node_cluster"):
        _same(getattr(port, field), getattr(ref, field))
    assert len(port.test_x) == len(ref.test_x) == port.k
    for a, b in zip(port.test_x + port.test_y, ref.test_x + ref.test_y):
        _same(a, b)
    assert port.transforms == ref.transforms


def test_sample_round_batches_gathers_the_reference_batches():
    ds = _make(synthetic, QUICKSTART)
    key = jax.random.PRNGKey(5)
    want = ref_pipeline.sample_round_batches(key, ds.train_x, ds.train_y,
                                             3, 4)
    idx = jax.random.randint(key, (ds.n_nodes, 3, 4), 0, ds.train_x.shape[1])
    train_x, train_y = pipeline.place(ds, "cpu")
    got = pipeline.sample_round_batches(torch.from_numpy(np.array(idx)),
                                        train_x, train_y)
    _same(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))


def test_draw_batch_indices_shape_range_and_determinism():
    a = pipeline.draw_batch_indices(torch.Generator().manual_seed(0),
                                    4, 3, 2, 7)
    b = pipeline.draw_batch_indices(torch.Generator().manual_seed(0),
                                    4, 3, 2, 7)
    assert a.shape == (4, 3, 2) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 7
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (3, 8)])
def test_padded_eval_batches(n, batch):
    x = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    got, want = (pipeline.padded_eval_batches(x, batch),
                 ref_pipeline.padded_eval_batches(x, batch))
    for a, b in zip(got, want):
        _same(a, b)


def test_place_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.place(_make(synthetic, QUICKSTART))
