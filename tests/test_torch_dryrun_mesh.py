"""The dry run on a mesh (``repro_torch.launch.dryrun``, ``--mesh pod``)
on the CPU: llama3.2-1b's smoke ``train_4k`` step on a fake (data 4,
model 2) world, shrunk as ``tests/test_dryrun_mini.py`` shrinks the
reference's (batch 8, sequence 64), counts one card's FLOPs — the
perfect split of this file's analytic count over 8 ranks, and no more
than the vocabulary product's share above it — and a collective term;
at mesh (1, 1) every count equals the single-card dry run's (its bytes
less the metadata queries', which only one card counts); and the CLI
runs ``--mesh pod``, ``--multi-pod`` and ``--facade`` on the
production meshes with the smoke model (the full input shapes on fake
tensors), with the reference's record keys and mesh names, and refuses
the mesh flags on one card."""
from __future__ import annotations

import json

import pytest
import torch

import repro_torch.configs  # noqa: F401  (registry)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.models.base import get_config
from repro_torch.roofline import analyze_step
from repro_torch.launch.mesh import HW

torch.set_num_threads(1)

CUT = dict(batch=8, seq=64)


def _smoke():
    return get_config("llama3.2-1b", smoke=True)


def _analytic_train_flops(b, s):
    """``tests/test_torch_roofline.py``'s count of the smoke train step
    with remat: (the layers' total, the tied head's)."""
    cfg = _smoke()
    d, hq, hkv, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, cfg.d_ff, cfg.vocab_size)
    t = b * s
    per_layer = (2 * t * d * (hq + 2 * hkv) * hd + 2 * t * hq * hd * d
                 + 3 * 2 * t * d * f + 2 * 2 * b * hq * s * s * hd)
    layers = cfg.n_layers * per_layer
    last = cfg.n_layers * 2 * t * f * d
    return layers * 3 + layers - last, 3 * t * 2 * d * v


@pytest.mark.parametrize("seq_model", [True, False])
def test_train_step_on_a_4x2_mesh_counts_one_card(seq_model):
    with fake_world(8):
        mesh = make_debug_mesh((4, 2), ("data", "model"), device="cpu")
        case, cost = dryrun.trace_case("llama3.2-1b", "train_4k", mesh,
                                       cfg=_smoke(), seq_model=seq_model,
                                       **CUT)
    layers, head = _analytic_train_flops(CUT["batch"], CUT["seq"])
    split = (layers + head) / 8
    assert split <= cost.flops <= split + head / 4
    rep = analyze_step(cost, arch="llama3.2-1b", shape="train_4k",
                       mesh_name="mini", chips=8, hw=HW,
                       n_params_active=1, n_tokens=8 * 64, kind="train")
    row = rep.row()
    assert row["t_collective_s"] > 0 and row["coll_gbytes_per_dev"] > 0
    assert sum(rep.collective_counts.values()) == len(cost.collectives)
    assert {"all-gather", "all-reduce"} <= {n for n, _ in cost.collectives}
    assert row["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_mesh_1x1_counts_equal_one_card(shape):
    cut = dict(CUT, batch=2)
    _, one = dryrun.trace_case("llama3.2-1b", shape, None, cfg=_smoke(),
                               **cut)
    with fake_world(1):
        mesh = make_debug_mesh((1, 1), ("data", "model"), device="cpu")
        case, got = dryrun.trace_case("llama3.2-1b", shape, mesh,
                                      cfg=_smoke(), **cut)
    assert (got.flops, got.bytes, got.peak_bytes) == \
        (one.flops, one.bytes - one.metadata_bytes, one.peak_bytes)
    assert got.collectives == ()


@pytest.mark.parametrize("shape, extra, name, chips", [
    ("prefill_32k", [], "pod16x16", 256),
    ("long_500k", ["--multi-pod"], "pod2x16x16", 512)])
def test_cli_runs_the_production_meshes(shape, extra, name, chips, tmp_path,
                                        monkeypatch):
    """The smoke model at the full input shape (fake tensors)."""
    monkeypatch.setattr(dryrun.steps, "resolve_config",
                        lambda arch, shape: _smoke())
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", shape,
                        "--mesh", "pod", "--out", str(out), *extra]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["mesh"] == name
    assert rec["chips"] == chips and rec["t_collective_s"] > 0
    assert rec["hlo_gflops_per_dev"] > 0


def test_cli_refuses_mesh_flags_on_one_card():
    for flags in (["--multi-pod"], ["--no-fsdp"], ["--no-seq-model"],
                  ["--mesh", "pod", "--unroll"]):
        with pytest.raises(SystemExit):
            dryrun.main(["--all", *flags])


def test_cli_runs_facade_on_the_multi_pod_mesh(tmp_path, monkeypatch):
    """FACADE's step on ``pod2x16x16``: its two nodes on 'pod', each
    pod's ranks running their own node; the smoke model at the reference
    case's batch and length (fake tensors)."""
    monkeypatch.setattr(dryrun.steps, "get_config", lambda arch: _smoke())
    out = tmp_path / "f.jsonl"
    assert dryrun.main(["--facade", "llama3.2-1b", "--mesh", "pod",
                        "--multi-pod", "--out", str(out)]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["mesh"] == "pod2x16x16"
    assert rec["shape"] == "facade_pod" and rec["chips"] == 512
    assert rec["t_collective_s"] > 0 and rec["hlo_gflops_per_dev"] > 0
