"""The port's training launcher (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``) on the CPU.

Paper mode prints the reference's JSON keys and appends the reference's
record with ``--out``; the communication volume (``total_gb``, the bytes
per round) is exact, whatever the draws. LM mode: the port's train step,
started from the reference's smoke init (``interop.lm_params_from_jax``)
on the same token batches, gives the losses the reference's ``lm_main``
prints, within 1e-4 (printed to 4 decimals, so up to 5e-5 of it is the
printing; the rest is fp32 in other summation orders); ``--ckpt`` writes
a file both packages load, equal to the final params."""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_io
from repro.launch import train as ref_train
from repro.models import api as ref_api
from repro.models.base import get_config as ref_get_config
from repro_torch import optim
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data import tokens
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch import train
from repro_torch.models.base import get_config
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
LOSS_TOL = 1e-4
PAPER = ["--model", "resnet8", "--algo", "dpsgd", "--clusters", "3", "1",
         "--rounds", "2", "--eval-every", "1", "--degree", "2",
         "--local-steps", "2", "--n-classes", "4", "--samples-per-class",
         "4"]
LM = ["--mode", "lm", "--arch", "llama3.2-1b", "--steps", "3", "--batch",
      "2", "--seq", "16", "--log-every", "1", "--lr", "0.01"]


def _summary(out: str) -> dict:
    """The JSON object ``paper_main`` prints after its per-eval lines."""
    return json.loads(out[out.index("\n{") + 1:])


def test_paper_mode_prints_the_reference_summary(tmp_path, capsys):
    ref_out, port_out = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    ref_train.main(PAPER + ["--out", str(ref_out)])
    want = _summary(capsys.readouterr().out)
    res = train.main(PAPER + ["--device", "cpu", "--out", str(port_out)])
    got = _summary(capsys.readouterr().out)
    assert list(got) == list(want) == [
        "algo", "clusters", "final_acc_per_cluster", "best_fair_acc", "dp",
        "eo", "total_gb"]
    assert got["total_gb"] == want["total_gb"] == res.comm.total_gb
    assert got["algo"] == "dpsgd" and got["clusters"] == [3, 1]
    assert len(got["final_acc_per_cluster"]) == 2
    ref_rec = json.loads(ref_out.read_text())
    rec = json.loads(port_out.read_text())
    assert list(rec) == list(ref_rec)
    assert list(rec["comm"]) == list(ref_rec["comm"])
    assert rec["comm"]["bytes"] == ref_rec["comm"]["bytes"]
    assert rec["comm"]["rounds"] == ref_rec["comm"]["rounds"] == [1, 2]


def test_lm_step_from_the_reference_init_gives_its_losses(capsys):
    """The reference's ``lm_main`` (seed 0) prints its first 3 losses; the
    port's step function from the same initial params (the reference's
    ``k_init``) and AdamW on the same token batches gives them again."""
    check_lm_steps("llama3.2-1b", capsys)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-moe-16b",
                                  "whisper-tiny", "llava-next-34b"])
def test_lm_steps_of_the_mla_and_moe_smoke_configs(arch, capsys):
    """The same on the MLA and MoE smoke configs (the loss with MoE's
    router term) and on the encoder-decoder and VLM ones (zero frames and
    zero image embeddings beside the tokens, as the reference's lm mode
    adds them), and the port's own lm mode runs them."""
    check_lm_steps(arch, capsys)
    out = train.main(LM + ["--arch", arch, "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()


def check_lm_steps(arch, capsys):
    ref_train.main(LM + ["--arch", arch])
    printed = [float(line.split()[3]) for line in
               capsys.readouterr().out.splitlines()
               if line.startswith("step")]
    assert len(printed) == 3
    cfg = get_config(arch, smoke=True)
    k_init = jax.random.split(jax.random.PRNGKey(0))[0]
    params = lm_params_from_jax(jax.tree.map(np.asarray, ref_api.init_params(
        ref_get_config(arch, smoke=True), k_init)))
    opt = optim.adamw(0.01)
    opt_state = opt.init(params)
    step = train.make_train_step(cfg, opt)
    stream = tokens.make_clustered_tokens(
        tokens.TokenSpec(vocab_size=cfg.vocab_size, seq_len=17, seed=0),
        (1,), seqs_per_node=6)["train"][0]
    losses = []
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in
                 tokens.lm_batch(stream[2 * i:2 * i + 2]).items()}
        batch.update(train.lm_extras(cfg, 2, "cpu"))
        params, opt_state, loss, metrics = step(params, opt_state, batch)
        losses.append(loss.item())
        assert not loss.requires_grad and 0.0 <= metrics["acc"].item() <= 1
    np.testing.assert_allclose(losses, printed, rtol=0, atol=LOSS_TOL)
    assert opt_state["count"] == 3
    if arch == "llama3.2-1b":
        assert losses[2] < losses[0]


def test_lm_mode_checkpoint_loads_in_both_packages(tmp_path, capsys):
    path = str(tmp_path / "lm.npz")
    out = train.main(LM + ["--arch", "rwkv6-1.6b", "--device", "cpu",
                           "--ckpt", path])
    lines = capsys.readouterr().out.splitlines()
    assert len([ln for ln in lines if ln.startswith("step")]) == 3
    assert lines[-1] == f"checkpoint -> {path}"
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    got, meta = ckpt_io.load(path)
    assert meta == {} and got["step"].item() == 3
    want = jax.tree.leaves(out["params"])          # by sorted key, as jax
    assert len(want) == len(tree_leaves(out["params"]))
    for a, b in zip(jax.tree.leaves(got["params"]), want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref, _ = ref_io.load(path)
    for a, b in zip(jax.tree.leaves(ref["params"]), want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_lm_extras_are_the_references_stub_inputs():
    """Zero image embeddings for a VLM and zero frames for an
    encoder-decoder, in the param dtype; nothing for the others."""
    vlm = get_config("llava-next-34b", smoke=True)
    enc = get_config("whisper-tiny", smoke=True)
    got = train.lm_extras(vlm, 3, "cpu")
    assert list(got) == ["img_embeds"]
    assert got["img_embeds"].shape == (3, vlm.n_image_tokens, vlm.d_model)
    got = train.lm_extras(enc.replace(dtype="bfloat16"), 2, "cpu")
    assert list(got) == ["frames"] and got["frames"].dtype == torch.bfloat16
    assert got["frames"].shape == (2, enc.encoder_seq, enc.d_model)
    assert not got["frames"].any()
    assert train.lm_extras(get_config("hymba-1.5b", smoke=True), 2,
                           "cpu") == {}


def test_the_card_is_never_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(LM + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(PAPER + ["--device", "cuda"])
