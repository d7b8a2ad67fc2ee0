"""FACADE on the RWKV6 language model: the port against the JAX reference
on the CPU, on the rwkv6-1.6b smoke config (fp32), with the reference's
parameters carried across by ``interop.lm_params_from_jax``. The checks
and tolerances are ``test_torch_facade_lm.py``'s for llama3.2-1b:
``loss_fn`` value 1e-5 and gradients 1e-4 (against ``jax.grad``); one
``facade_round`` in the main variant (the warmup variant does not depend
on the family): selection losses 1e-5, cluster ids exact where the two
heads' losses are more than 1e-4 apart, cores and heads within 1e-4 of
each leaf's scale, ``round_bytes`` exact.

The port trains the wkv recurrence through ``kernels/rwkv6.wkv_train``
(its backward differentiates the plain ``wkv_scan``); the reference
through ``lax.scan`` in rematerialised chunks.
"""
from __future__ import annotations

import jax
import torch

import repro_torch.configs  # noqa: F401  (registry)
from repro.core import split as ref_split
from repro.core.bindings import make_binding as ref_make_binding
from repro.core.state import init_facade_state as ref_init_facade
from repro.models.base import get_config as ref_get_config
from repro_torch.core import facade
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import init_facade_state
from repro_torch.models.base import get_config
from repro_torch.tree import tree_leaves
from test_torch_facade_lm import check_facade_round, check_loss_fn

torch.set_num_threads(1)
ARCH = "rwkv6-1.6b"


def test_loss_fn_value_and_gradients_match_the_reference():
    """The config's own untied ``lm_head`` (RWKV ties no embeddings)."""
    check_loss_fn(ARCH, untied=True)


def test_facade_round_matches_the_reference():
    check_facade_round(ARCH, warmup=False)


def test_payload_counts_the_fp32_leaves_at_four_bytes():
    """In bf16 each node's core still holds ``decay_base`` and ``bonus_u``
    in fp32 (2 x d x layers values): a push (core, one head, the 4-byte
    id) counts them at 4 bytes, as the reference does."""
    rcfg = ref_get_config(ARCH, smoke=True).replace(dtype="bfloat16")
    cfg = get_config(ARCH, smoke=True).replace(dtype="bfloat16")
    rst = ref_init_facade(ref_make_binding(rcfg), jax.random.PRNGKey(0), 2,
                          2)
    want = (ref_split.tree_size_bytes(jax.tree.map(lambda l: l[0],
                                                   rst.cores))
            + ref_split.tree_size_bytes(jax.tree.map(lambda l: l[0, 0],
                                                     rst.heads)) + 4)
    st = init_facade_state(make_binding(cfg), 2, 2, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    fp32 = [l[0] for l in tree_leaves(st.cores) if l.dtype == torch.float32]
    assert sum(l.numel() for l in fp32) == 2 * cfg.d_model * cfg.n_layers
    assert facade.payload_bytes(st) == want
