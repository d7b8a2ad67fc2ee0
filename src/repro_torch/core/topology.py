"""Communication topologies (paper Sec. III-D step 1).

Each round FACADE (and the EL baseline) uses a fresh random r-regular
undirected graph, built as the union of ``r/2`` random cyclic permutations
(plus their inverses), with one extra random matching for odd r. The
permutations are an input, so a run can replay another's draws exactly;
:func:`draw_perms` draws them from a ``torch.Generator``. D-PSGD and DEPRL
use the static :func:`ring`; DAC samples its own graph (``baselines/dac``)
and mixes with :func:`weighted_mixing`.

All of them return a dense adjacency ``A [n, n]`` (float32, 0/1, zero
diagonal); :func:`mixing_matrix` turns it into the row-stochastic W of
Eq. 3/4.
"""
from __future__ import annotations

import torch


def _check_degree(n: int, r: int):
    if not 1 <= r < n:
        raise ValueError(
            f"degree={r} out of range for n={n} nodes: a simple graph "
            f"supports 1 <= degree <= n - 1 (multi-edges collapse)")


def set_edges(a, rows, cols):
    """``a[rows, cols] = 1`` with the one made on ``a``'s device: a Python
    scalar written into a CUDA tensor by indexing is staged on the host and
    synchronises, which a round captured in a CUDA graph must not."""
    a.index_put_((rows, cols), torch.ones((), dtype=a.dtype,
                                          device=a.device))


def n_perms(r: int) -> int:
    """How many permutations :func:`random_regular` reads for degree r."""
    return max(1, r // 2) + r % 2


def draw_perms(generator: torch.Generator, n: int, r: int) -> torch.Tensor:
    """``[n_perms(r), n]`` random permutations of the n nodes."""
    return torch.stack([
        torch.randperm(n, generator=generator, device=generator.device)
        for _ in range(n_perms(r))])


def random_regular(perms, n: int, r: int) -> torch.Tensor:
    """Random r-regular-ish undirected graph from ``perms [n_perms(r), n]``:
    each of the first ``max(1, r//2)`` permutations adds a cycle; for odd
    r the last one pairs consecutive halves into a matching. Symmetric,
    zero diagonal, multi-edges collapse. Raises ``ValueError`` when ``r``
    is outside ``[1, n - 1]``."""
    _check_degree(n, r)
    if perms.shape != (n_perms(r), n):
        raise ValueError(f"perms must be [{n_perms(r)}, {n}] for degree "
                         f"{r}, got {tuple(perms.shape)}")
    a = torch.zeros((n, n), dtype=torch.float32, device=perms.device)
    for perm in perms[:max(1, r // 2)]:
        dst = torch.roll(perm, 1)
        set_edges(a, perm, dst)
        set_edges(a, dst, perm)
    if r % 2 == 1:
        perm = perms[-1]
        half = n // 2
        u, v = perm[:half], perm[half:2 * half]
        set_edges(a, u, v)
        set_edges(a, v, u)
    a.fill_diagonal_(0.0)
    return a


def ring(n: int, r: int = 2, device="cpu") -> torch.Tensor:
    """Static ring with ``max(1, r // 2)`` hops on each side. Raises
    ``ValueError`` when ``r`` is outside ``[1, n - 1]``."""
    _check_degree(n, r)
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    idx = torch.arange(n, device=device)
    for hop in range(1, max(1, r // 2) + 1):
        set_edges(a, idx, (idx + hop) % n)
        set_edges(a, (idx + hop) % n, idx)
    a.fill_diagonal_(0.0)
    return a


def fully_connected(n: int, device="cpu") -> torch.Tensor:
    return (torch.ones((n, n), dtype=torch.float32, device=device)
            - torch.eye(n, device=device))


def effective_adjacency(adj, edge_mask, active) -> torch.Tensor:
    """The adjacency that carried messages this round (network
    simulation): drawn edges masked by per-edge delivery and by both
    endpoints being online. Symmetric when ``edge_mask`` is; an offline
    node ends with degree 0, and :func:`mixing_matrix` then gives it the
    self-weight-1 row (it keeps its own model)."""
    return adj * edge_mask * active[:, None] * active[None, :]


def mixing_matrix(adj) -> torch.Tensor:
    """Row-stochastic W with uniform weights over {neighbors} ∪ {self}:
    W[i, j] = 1/(deg_i + 1) for j ∈ N(i) ∪ {i} (Eq. 3 aggregation)."""
    n = adj.shape[0]
    a_hat = adj + torch.eye(n, dtype=adj.dtype, device=adj.device)
    return a_hat / a_hat.sum(dim=1, keepdim=True)


def weighted_mixing(adj, weights) -> torch.Tensor:
    """DAC's row-stochastic W: nonnegative ``weights`` masked by the
    adjacency, plus a self edge weighing the row's largest weight (at
    least 1e-6), each row normalised."""
    w = weights * adj
    w = w + torch.diag(w.max(dim=1).values.clamp(min=1e-6))
    return w / w.sum(dim=1, keepdim=True)


def degrees(adj) -> torch.Tensor:
    return adj.sum(dim=1)
