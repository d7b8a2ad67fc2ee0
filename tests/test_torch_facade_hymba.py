"""FACADE on the hybrid language model: one ``facade_round`` of the
hymba-1.5b smoke config (fp32) in the main variant, from the reference's
draws (``torch_caps.JaxDraws``: initial state, batch indices, topology),
against the reference's round, with ``test_torch_facade_lm.py``'s checks
and tolerances: selection losses 1e-5, cluster ids exact where the two
heads' losses are more than 1e-4 apart, cores and heads within 1e-4 of
each leaf's scale (the mamba branch's fp32 ``dt_bias``, ``a_log`` and
``d_skip`` among them), ``round_bytes`` exact. Local SGD differentiates
the plain scan through the LM binding."""
from __future__ import annotations

import torch

from test_torch_facade_lm import check_facade_round, check_loss_fn

torch.set_num_threads(1)


def test_loss_fn_value_and_gradients_match_the_reference():
    """hymba ties no embeddings: the config's own untied ``lm_head``."""
    check_loss_fn("hymba-1.5b", untied=True)


def test_facade_round_matches_the_reference():
    check_facade_round("hymba-1.5b", warmup=False)
