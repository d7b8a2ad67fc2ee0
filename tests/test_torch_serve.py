"""The port's serving loop against the reference's on the CPU: the same
request queue (numpy's generator, one seed) through ``serve`` and through
a loop over the reference's ``transformer.prefill`` and ``decode_step``
that pads, samples and advances positions as ``repro.launch.serve`` does.
Greedy tokens must be equal; prefill logits agree within 1e-4 (fp32, other
summation order). The ``--net`` and ``--trace-jsonl`` overlays against the
reference server's: the same SLO line and simulated seconds, and traces
with the same records."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registry)
from repro.models import api as ref_api
from repro.models import transformer as ref_tf
from repro.models.base import get_config as ref_get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch import serve as port_serve
from repro_torch.models.base import get_config

torch.set_num_threads(1)
N_REQ, BATCH, PROMPT, GEN = 5, 2, 16, 6


def _reference_serve(cfg, params, queue, prompt=PROMPT, gen_len=GEN):
    """``repro.launch.serve.main``'s request loop, greedy, without jit."""
    cache_len = ref_tf.cache_physical_len(cfg, prompt + gen_len)
    out, first_logits = [], []
    queue = list(queue)
    while queue:
        reqs, queue = queue[:BATCH], queue[BATCH:]
        lens = np.array([len(r) for r in reqs], np.int32)
        toks = np.zeros((len(reqs), prompt), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :len(r)] = r
        logits, cache = ref_tf.prefill(cfg, params, jnp.asarray(toks),
                                       cache_extra=cache_len - prompt)
        first_logits.append(np.asarray(logits))
        last = jnp.argmax(logits, -1).astype(jnp.int32)
        pos = jnp.asarray(lens)
        gen = np.zeros((len(reqs), gen_len), np.int32)
        for t in range(gen_len):
            gen[:, t] = np.asarray(last)
            logits, cache = ref_tf.decode_step(cfg, params, cache,
                                               last[:, None], pos)
            last = jnp.argmax(logits, -1).astype(jnp.int32)
            pos = pos + 1
        out.append(gen)
    return np.concatenate(out), first_logits


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b", "qwen3-8b",
                                  "stablelm-12b", "minicpm3-4b",
                                  "deepseek-moe-16b", "grok-1-314b",
                                  "hymba-1.5b", "llava-next-34b"])
def test_serve_matches_the_reference_loop(arch):
    ref_cfg = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    ref_params = ref_api.init_params(ref_cfg, jax.random.PRNGKey(0))
    queue = port_serve.make_requests(np.random.default_rng(0), N_REQ, PROMPT,
                                     cfg.vocab_size)
    want, want_logits = _reference_serve(ref_cfg, ref_params, queue)
    res = port_serve.serve(cfg, lm_params_from_jax(ref_params), queue,
                           batch=BATCH, prompt_len=PROMPT, gen_len=GEN,
                           device="cpu")
    assert res.batch_sizes == [2, 2, 1] and res.finite
    np.testing.assert_array_equal(res.tokens, want)
    for got, ref in zip(res.prefill_logits, want_logits):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert res.prefill_tok_s > 0 and res.decode_tok_s > 0


def test_hymba_serve_past_its_window_matches_the_reference_loop():
    """hymba-smoke with 96-token prompts (its window is 64): the prefill
    keeps a 64-slot ring buffer, which decode writes around, and the
    mamba state carries the whole prompt; equal greedy tokens."""
    arch, prompt, gen_len = "hymba-1.5b", 96, 8
    ref_cfg = ref_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    ref_params = ref_api.init_params(ref_cfg, jax.random.PRNGKey(1))
    queue = port_serve.make_requests(np.random.default_rng(1), 3, prompt,
                                     cfg.vocab_size)
    want, want_logits = _reference_serve(ref_cfg, ref_params, queue,
                                         prompt, gen_len)
    res = port_serve.serve(cfg, lm_params_from_jax(ref_params), queue,
                           batch=BATCH, prompt_len=prompt, gen_len=gen_len,
                           device="cpu")
    assert res.finite and cfg.sliding_window < prompt
    np.testing.assert_array_equal(res.tokens, want)
    for got, ref in zip(res.prefill_logits, want_logits):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_make_requests_is_the_reference_queue():
    from repro.launch.serve import make_requests
    for a, b in zip(make_requests(np.random.default_rng(4), 6, 32, 100),
                    port_serve.make_requests(np.random.default_rng(4), 6, 32,
                                             100)):
        np.testing.assert_array_equal(a, b)


def test_sampling_draws_from_the_seeded_generator():
    cfg = get_config("llama3.2-1b", smoke=True)
    params = port_serve.api.init_params(cfg, torch.Generator().manual_seed(1))
    queue = port_serve.make_requests(np.random.default_rng(1), 2, 8,
                                     cfg.vocab_size)
    runs = [port_serve.serve(cfg, params, queue, batch=2, prompt_len=8,
                             gen_len=4, temperature=1.0, seed=s,
                             device="cpu").tokens for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0][:, 1:], runs[2][:, 1:])


def test_main_serves_a_smoke_config_on_the_cpu(capsys):
    port_serve.main(["--arch", "rwkv6-1.6b", "--requests", "3", "--batch",
                     "2", "--prompt-len", "8", "--gen-len", "3",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("batch of") == 2 and "served 3 requests" in out


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-moe-16b"])
def test_main_serves_the_mla_and_moe_smoke_configs(arch, capsys):
    port_serve.main(["--arch", arch, "--requests", "3", "--batch", "2",
                     "--prompt-len", "8", "--gen-len", "3", "--device",
                     "cpu"])
    out = capsys.readouterr().out
    assert out.count("batch of") == 2 and "served 3 requests" in out


# ------------------------------------------- the --net and --trace overlays --
OVERLAY_ARGS = ["--arch", "llama3.2-1b", "--requests", "3", "--batch", "2",
                "--prompt-len", "8", "--gen-len", "3", "--net", "edge-v2"]


def _slo_line(out: str) -> str:
    (line,) = [ln for ln in out.splitlines() if ln.startswith("SLO [")]
    return line


def test_net_and_trace_overlays_match_the_reference_server(tmp_path,
                                                           capsys):
    """``--net edge-v2 --trace-jsonl`` on the port's server and on the
    reference's, same queue: the same SLO line (simulated seconds, bytes,
    drain times), and traces with the same records in the same order
    (types, names and keys), one ``queue.wait`` event, ``prefill`` and
    ``decode`` span a batch and a final ``slo`` event."""
    from repro.launch import serve as ref_serve
    from repro_torch.obs import read_jsonl
    ref_serve.main(OVERLAY_ARGS + ["--trace-jsonl",
                                   str(tmp_path / "ref.jsonl")])
    want_slo = _slo_line(capsys.readouterr().out)
    port_serve.main(OVERLAY_ARGS + ["--trace-jsonl",
                                    str(tmp_path / "port.jsonl"),
                                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert _slo_line(out) == want_slo
    assert f"trace: 7 records -> {tmp_path / 'port.jsonl'}" in out
    got, want = (read_jsonl(tmp_path / f"{p}.jsonl") for p in ("port",
                                                                "ref"))
    assert [(r["type"], r["name"], sorted(r)) for r in got] == [
        (r["type"], r["name"], sorted(r)) for r in want]
    assert [r["name"] for r in got if r["type"] == "span"] == [
        "prefill", "decode", "prefill", "decode"]
    assert [(r["batch"], r["queued"]) for r in got
            if r["name"] == "queue.wait"] == [(0, 3), (1, 1)]
    slo = got[-1]
    assert slo["name"] == "slo" and slo["net"] == "edge-v2"
    assert slo["requests"] == 3 and slo["tokens"] == 9
    assert slo["sim_net_s"] == pytest.approx(want[-1]["sim_net_s"],
                                             rel=1e-12)
    assert set(slo["rollup"]) == {"prefill", "decode"}


@pytest.mark.parametrize("preset", sorted(port_serve.netsim.PRESETS))
def test_the_wire_model_is_the_references(preset):
    from repro import netsim as ref_netsim
    from repro.launch import serve as ref_serve
    net = port_serve.netsim.NetworkConfig.preset(preset)
    ref = ref_netsim.NetworkConfig.preset(preset)
    assert port_serve.wire_params(net) == ref_serve.wire_params(ref)
    for args in ((64.0, 32, 512.0), (4096.0, 1, 16.0)):
        assert port_serve.batch_net_seconds(net, *args) == \
            ref_serve.batch_net_seconds(ref, *args)


def test_serve_records_each_batch_on_the_wire():
    cfg = get_config("llama3.2-1b", smoke=True)
    params = port_serve.api.init_params(cfg, torch.Generator().manual_seed(2))
    queue = port_serve.make_requests(np.random.default_rng(2), 5, 8,
                                     cfg.vocab_size)
    net = port_serve.netsim.NetworkConfig.preset("hostile")
    res = port_serve.serve(cfg, params, queue, batch=2, prompt_len=8,
                           gen_len=3, net=net, device="cpu")
    plain = port_serve.serve(cfg, params, queue, batch=2, prompt_len=8,
                             gen_len=3, device="cpu")
    np.testing.assert_array_equal(res.tokens, plain.tokens)
    assert plain.comm is None and res.comm.rounds == [1, 2, 3]
    assert res.comm.acc == [0.4, 0.8, 1.0]
    want, row = 0.0, 0
    for b in res.batch_sizes:
        prompt = float(sum(len(q) for q in queue[row:row + b])) * 4
        want += port_serve.batch_net_seconds(net, prompt, 3, b * 3 * 4.0)
        row += b
    assert res.comm.seconds[-1] == pytest.approx(want, rel=1e-12)
