"""Synthetic clustered token streams for running FACADE over LM backbones
(the port's own copy of ``repro.data.tokens``: numpy only, equal arrays
for equal seeds).

Feature heterogeneity for language: every cluster observes the same
underlying sequence process through a cluster-specific *vocabulary
permutation* — the LM analogue of the paper's image rotations (structure
preserved, surface features shifted). Sequences follow a sparse first-order
Markov chain so they are learnable by small models in few steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenSpec:
    vocab_size: int = 512
    seq_len: int = 64
    branching: int = 4     # successors per token in the Markov chain
    seed: int = 0


def _chain(rng, spec: TokenSpec):
    return rng.integers(0, spec.vocab_size,
                        size=(spec.vocab_size, spec.branching))


def _gen(rng, succ, spec: TokenSpec, n_seq: int):
    toks = np.empty((n_seq, spec.seq_len), np.int64)
    cur = rng.integers(0, spec.vocab_size, size=n_seq)
    for t in range(spec.seq_len):
        toks[:, t] = cur
        pick = rng.integers(0, succ.shape[1], size=n_seq)
        cur = succ[cur, pick]
    return toks


def make_clustered_tokens(spec: TokenSpec, cluster_sizes, seqs_per_node: int,
                          test_seqs: int = 64):
    """Returns dict with train [n, N, S], per-cluster test [k][M, S],
    node_cluster [n]."""
    rng = np.random.default_rng(spec.seed)
    succ = _chain(rng, spec)
    k = len(cluster_sizes)
    perms = [np.arange(spec.vocab_size)]
    for _ in range(k - 1):
        perms.append(rng.permutation(spec.vocab_size))

    train, node_cluster = [], []
    for c, size in enumerate(cluster_sizes):
        for _ in range(size):
            seq = _gen(rng, succ, spec, seqs_per_node)
            train.append(perms[c][seq])
            node_cluster.append(c)
    test = [perms[c][_gen(rng, succ, spec, test_seqs)] for c in range(k)]
    return {
        "train": np.stack(train).astype(np.int32),
        "test": [t.astype(np.int32) for t in test],
        "node_cluster": np.asarray(node_cluster, np.int32),
    }


def lm_batch(tokens: np.ndarray):
    """next-token-prediction batch dict from [., S] token block."""
    return {
        "tokens": tokens[..., :-1],
        "labels": tokens[..., 1:],
        "mask": np.ones(tokens[..., 1:].shape, np.float32),
    }
