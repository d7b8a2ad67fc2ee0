"""The port's serving loop against the reference's on the CPU: the same
request queue (numpy's generator, one seed) through ``serve`` and through
a loop over the reference's ``transformer.prefill`` and ``decode_step``
that pads, samples and advances positions as ``repro.launch.serve`` does.
Greedy tokens must be equal; prefill logits agree within 1e-4 (fp32, other
summation order)."""
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


def _reference_serve(cfg, params, queue):
    """``repro.launch.serve.main``'s request loop, greedy, without jit."""
    cache_len = ref_tf.cache_physical_len(cfg, PROMPT + GEN)
    out, first_logits = [], []
    queue = list(queue)
    while queue:
        reqs, queue = queue[:BATCH], queue[BATCH:]
        lens = np.array([len(r) for r in reqs], np.int32)
        toks = np.zeros((len(reqs), PROMPT), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :len(r)] = r
        logits, cache = ref_tf.prefill(cfg, params, jnp.asarray(toks),
                                       cache_extra=cache_len - PROMPT)
        first_logits.append(np.asarray(logits))
        last = jnp.argmax(logits, -1).astype(jnp.int32)
        pos = jnp.asarray(lens)
        gen = np.zeros((len(reqs), GEN), np.int32)
        for t in range(GEN):
            gen[:, t] = np.asarray(last)
            logits, cache = ref_tf.decode_step(cfg, params, cache,
                                               last[:, None], pos)
            last = jnp.argmax(logits, -1).astype(jnp.int32)
            pos = pos + 1
        out.append(gen)
    return np.concatenate(out), first_logits


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
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
