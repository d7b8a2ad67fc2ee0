"""FACADE on the MLA and MoE language models: the port against the JAX
reference on the CPU, on the minicpm3-4b and deepseek-moe-16b smoke
configs (fp32), with the reference's parameters carried across by
``interop.lm_params_from_jax``. The checks and tolerances are
``test_torch_facade_lm.py``'s for llama3.2-1b: ``loss_fn`` value (with
``router_aux_coef`` times MoE's router loss) and its metrics 1e-5,
gradients 1e-4 (against ``jax.grad``); one ``facade_round`` on
deepseek-moe-16b in the main variant from the reference's draws:
selection losses 1e-5, cluster ids exact where the two heads' losses are
more than 1e-4 apart, cores and heads within 1e-4 of each leaf's scale,
``round_bytes`` exact. Local SGD reaches the router loss through the LM
binding, which calls ``transformer.loss_fn``.
"""
from __future__ import annotations

import jax
import pytest
import torch

import repro_torch.configs  # noqa: F401  (registry)
from repro.core import split as ref_split
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_facade_state as ref_init_facade
from repro.models.base import get_config as ref_get_config
from repro_torch.core import facade
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import init_facade_state
from repro_torch.models import transformer
from repro_torch.models.base import get_config
from repro_torch.tree import tree_map
from test_torch_facade_lm import check_facade_round, check_loss_fn

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_loss_fn_value_and_gradients_match_the_reference(arch):
    """The config's own untied ``lm_head`` (neither ties embeddings)."""
    check_loss_fn(arch, untied=True)


def test_binding_loss_carries_the_router_loss():
    """The LM binding's per-node loss (what local SGD differentiates) is
    the NLL plus ``router_aux_coef`` times the router loss."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    binding = make_binding(cfg)
    params = binding.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "mask": torch.ones((1, 2, 16))}
    total, m = transformer.loss_fn(cfg, params,
                                   {k: v[0] for k, v in batch.items()})
    assert float(m["aux"]) > 0.5
    assert float(total) == float(m["ce"] + cfg.router_aux_coef * m["aux"])
    got = binding.node_losses(tree_map(lambda t: t[None], params), batch)
    assert got.shape == (1,) and float(got[0]) == float(total)


def test_facade_round_matches_the_reference():
    check_facade_round("deepseek-moe-16b", warmup=False)


def test_payload_counts_the_fp32_router_at_four_bytes():
    """In bf16 each node's core still holds every layer's router in fp32
    (d x E values a layer): a push (core, one head, the 4-byte id) counts
    it at 4 bytes, as the reference does."""
    arch = "deepseek-moe-16b"
    rcfg = ref_get_config(arch, smoke=True).replace(dtype="bfloat16")
    cfg = get_config(arch, smoke=True).replace(dtype="bfloat16")
    rst = ref_init_facade(ref_make_binding(rcfg), jax.random.PRNGKey(0), 2,
                          2)
    want = (ref_split.tree_size_bytes(jax.tree.map(lambda l: l[0],
                                                   rst.cores))
            + ref_split.tree_size_bytes(jax.tree.map(lambda l: l[0, 0],
                                                     rst.heads)) + 4)
    st = init_facade_state(make_binding(cfg), 2, 2, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    router = st.cores["layers"]["moe"]["router"]
    assert router.dtype == torch.float32
    assert router[0].numel() == cfg.n_layers * cfg.d_model * cfg.n_experts
    assert facade.payload_bytes(st) == want
