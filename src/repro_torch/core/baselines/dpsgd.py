"""D-PSGD baseline [Lian et al., NeurIPS'17]: decentralized SGD over a
static topology (paper Alg. 1 / Appendix B), here the reference's static
ring. Each round trains locally first, then mixes."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.tree import tree_map

from .. import split, topology
from ..bindings import Binding, gossip_mix, local_sgd
from ..state import BaselineState


@dataclasses.dataclass(frozen=True)
class DpsgdConfig:
    n_nodes: int
    degree: int = 4
    lr: float = 0.05


def dpsgd_round(cfg: DpsgdConfig, binding: Binding, state: BaselineState,
                batches):
    """batches: ``{"x": [n, H, B, ...], "y": [n, H, B]}``. The ring is
    static, so the round draws nothing."""
    leaf = next(iter(batches.values()))
    adj = topology.ring(cfg.n_nodes, cfg.degree, device=leaf.device)
    params = local_sgd(binding, state.params, batches, cfg.lr)
    params = gossip_mix(topology.mixing_matrix(adj), params)
    model_bytes = split.tree_size_bytes(
        tree_map(lambda l: l[0], state.params))
    round_bytes = float(np.float32(cfg.n_nodes * cfg.degree * model_bytes))
    return (state._replace(params=params, round=state.round + 1),
            {"round_bytes": round_bytes})
