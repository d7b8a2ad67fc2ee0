"""The port's checkpoint files (``repro_torch.checkpoint.io``) against the
reference's format (``repro.checkpoint.io``): a file either package writes
loads in the other with equal leaves, bit for bit, bf16, ``None``, lists
and tuples included; saves are atomic and a damaged file raises
``CheckpointError``."""
from __future__ import annotations

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_io
from repro_torch.checkpoint import CheckpointError, load, save

torch.set_num_threads(1)


def _port_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((3, 4), generator=g),
                       "emb": torch.randn((5, 2), generator=g).to(
                           torch.bfloat16)},
            "opt": {"count": 7, "m": [torch.arange(6, dtype=torch.int32),
                                      torch.tensor(2.5, dtype=torch.float64)]},
            "pair": (torch.ones(2, dtype=torch.bool), None),
            "none": None}


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_port_file_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "port.npz")
    tree = _port_tree()
    save(path, tree, meta={"step": 3})
    got, meta = ref_io.load(path)
    assert meta == {"step": 3}
    assert got["none"] is None and got["pair"][1] is None
    assert isinstance(got["pair"], tuple) and isinstance(got["opt"]["m"],
                                                         list)
    assert got["params"]["emb"].dtype == jnp.bfloat16
    for a, b in ((got["params"]["w"], tree["params"]["w"]),
                 (got["params"]["emb"], tree["params"]["emb"]),
                 (got["opt"]["m"][0], tree["opt"]["m"][0]),
                 (got["opt"]["m"][1], tree["opt"]["m"][1]),
                 (got["pair"][0], tree["pair"][0])):
        want = _as_numpy(b)
        assert a.dtype == want.dtype and a.shape == want.shape
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8))
    assert int(got["opt"]["count"]) == 7


def test_reference_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "ref.npz")
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    emb = np.asarray(jnp.asarray(rng.normal(size=(2, 5)), jnp.bfloat16))
    ref_io.save(path, {"params": {"w": jnp.asarray(w), "emb": emb},
                       "step": 11, "hist": [np.arange(3), None],
                       "pair": (np.float64(1.5), np.int32(4))},
                meta={"seed": 0})
    got, meta = load(path)
    assert meta == {"seed": 0}
    assert torch.equal(got["params"]["w"], torch.from_numpy(w))
    assert got["params"]["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["params"]["emb"].view(torch.int16).numpy().view(np.uint16),
        emb.view(np.uint16))
    assert got["step"].item() == 11 and got["step"].dtype == torch.int64
    assert torch.equal(got["hist"][0], torch.arange(3))
    assert got["hist"][1] is None and isinstance(got["hist"], list)
    assert isinstance(got["pair"], tuple)
    assert got["pair"][0].dtype == torch.float64
    assert got["pair"][1].dtype == torch.int32


def test_round_trip_in_the_port_and_atomic_save(tmp_path):
    path = str(tmp_path / "sub" / "ck.npz")
    tree = _port_tree()
    save(path, tree)
    assert sorted(os.listdir(tmp_path / "sub")) == ["ck.npz"]  # no .tmp
    got, meta = load(path)
    assert meta == {}
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["emb"], tree["params"]["emb"])
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert got["opt"]["count"].item() == 7
    save(path, {"x": torch.zeros(2)})                 # overwrite in place
    assert torch.equal(load(path)[0]["x"], torch.zeros(2))
    assert sorted(os.listdir(tmp_path / "sub")) == ["ck.npz"]


def test_damaged_files_raise(tmp_path):
    path = str(tmp_path / "ck.npz")
    save(path, _port_tree())
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(CheckpointError, match="truncated"):
        load(path)
    with open(path, "wb") as f:
        f.write(b"not an archive")
    with pytest.raises(CheckpointError):
        load(path)
    with pytest.raises(FileNotFoundError):
        load(str(tmp_path / "missing.npz"))
