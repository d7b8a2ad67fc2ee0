"""Epidemic Learning (EL) baseline [NeurIPS'23, de Vos et al.]:
D-PSGD over a fresh random r-regular topology each round. This is the
paper's primary baseline and the communication-cost reference point."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.tree import tree_map

from .. import split, topology
from ..bindings import Binding, gossip_mix, local_sgd
from ..state import BaselineState


@dataclasses.dataclass(frozen=True)
class ELConfig:
    n_nodes: int
    degree: int = 4
    lr: float = 0.05


def el_round(cfg: ELConfig, binding: Binding, state: BaselineState, batches,
             perms):
    """batches: ``{"x": [n, H, B, ...], "y": [n, H, B]}``; perms: the
    round's topology permutations (:func:`topology.random_regular`)."""
    adj = topology.random_regular(perms, cfg.n_nodes, cfg.degree)
    params = gossip_mix(topology.mixing_matrix(adj), state.params)
    params = local_sgd(binding, params, batches, cfg.lr)
    model_bytes = split.tree_size_bytes(
        tree_map(lambda l: l[0], state.params))
    round_bytes = float(np.float32(cfg.n_nodes * cfg.degree * model_bytes))
    return (BaselineState(params=params, round=state.round + 1),
            {"round_bytes": round_bytes})
