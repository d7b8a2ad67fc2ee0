"""DEPRL baseline [Xiong et al., AAAI'24]: personalised decentralized
learning with a shared representation. The cores are gossiped over the
static ring; each node's head is trained locally and never sent (the
paper observes it overfits and plateaus, Sec. V-B/V-D)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.tree import tree_map

from .. import split, topology
from ..bindings import Binding, gossip_mix, local_sgd
from ..state import BaselineState


@dataclasses.dataclass(frozen=True)
class DeprlConfig:
    n_nodes: int
    degree: int = 4
    lr: float = 0.01


def deprl_round(cfg: DeprlConfig, binding: Binding, state: BaselineState,
                batches):
    """Mix the cores over the ring, then H local steps on the merged core
    and each node's own head. ``state.params`` holds full models."""
    leaf = next(iter(batches.values()))
    adj = topology.ring(cfg.n_nodes, cfg.degree, device=leaf.device)
    cores, heads = split.split_params(state.params, binding.head_keys)
    cores = gossip_mix(topology.mixing_matrix(adj), cores)
    params = local_sgd(binding, split.merge_params(cores, heads), batches,
                       cfg.lr)
    core_bytes = split.tree_size_bytes(tree_map(lambda l: l[0], cores))
    round_bytes = float(np.float32(cfg.n_nodes * cfg.degree * core_bytes))
    return (state._replace(params=params, round=state.round + 1),
            {"round_bytes": round_bytes})
