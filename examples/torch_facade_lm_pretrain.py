"""FACADE pretraining of a transformer on clustered token streams.

    PYTHONPATH=src python examples/torch_facade_lm_pretrain.py \
        [--rounds 150] [--device cpu]

The port of ``examples/facade_lm_pretrain.py``, with the same flags:
the llama3.2-1b family, its smoke config by default, end to end.
Feature heterogeneity for language is a per-cluster vocabulary
permutation (structure preserved, surface statistics shifted: the LM
analogue of the paper's image rotations). FACADE's heads (final norm and
lm_head) specialize per cluster; the transformer core is shared. Each
round draws its batches from ``np.random.default_rng(0)``, as the
reference does, and its topology from the draws source, then runs
``facade_round``; step 2c scores every (node, head) pair through the
head-select kernel on the card. ``run(cfg=get_config(arch))`` runs the
published config at full width. Runs on the NVIDIA card unless
``--device`` names another device; raises where CUDA is missing.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.configs  # noqa: E402,F401  (registry)
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import facade as facade_mod  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.core.bindings import make_binding  # noqa: E402
from repro_torch.core.runner import TorchDraws  # noqa: E402
from repro_torch.core.state import init_facade_state  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data import tokens as tokens_mod  # noqa: E402
from repro_torch.models.base import get_config  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def evaluate(binding, state, data) -> list:
    """Per-cluster mean NLL of each node's deployed model (its core and
    the head of the cluster it reports) on the first 8 sequences of its
    cluster's held-out stream."""
    k = len(data["test"])
    dev = state.cluster_id.device
    losses = [[] for _ in range(k)]
    with torch.no_grad():
        for i, c in enumerate(data["node_cluster"]):
            core = tree_map(lambda l: l[i:i + 1], state.cores)
            heads = tree_map(lambda l: l[i:i + 1], state.heads)
            head = split.select_head(heads, state.cluster_id[i:i + 1])
            params = split.merge_params(core, head)
            batch = {kk: torch.from_numpy(vv[None]).to(dev) for kk, vv in
                     tokens_mod.lm_batch(data["test"][c][:8]).items()}
            losses[c].append(float(binding.loss(params, batch)))
    return [float(np.mean(l)) for l in losses if l]


def run(*, arch: str = "llama3.2-1b", cfg=None, rounds: int = 150,
        nodes=(3, 1), seq: int = 64, batch: int = 4, local_steps: int = 2,
        lr: float = 5e-3, eval_every: int = 25, head_jitter: float = 1e-3,
        seed: int = 0, verbose: bool = True, device="cuda",
        draws=None) -> dict:
    """FACADE rounds on ``arch`` (``cfg`` defaults to its smoke config)
    over nodes in clusters of ``nodes``; returns ``{"state", "evals":
    [(round, per-cluster NLL, cluster ids, rounds/s)], "node_cluster",
    "rounds_per_s"}``. ``draws`` is a callable of the seed giving the
    source of the initial parameters and the topologies (default
    ``TorchDraws``)."""
    dev = device_mod.resolve(device)
    cfg = cfg if cfg is not None else get_config(arch, smoke=True)
    binding = make_binding(cfg)
    n, k = sum(nodes), len(nodes)
    data = tokens_mod.make_clustered_tokens(
        tokens_mod.TokenSpec(vocab_size=cfg.vocab_size, seq_len=seq + 1,
                             seed=0), tuple(nodes),
        seqs_per_node=rounds * local_steps * batch // 4)
    train = torch.from_numpy(data["train"]).to(dev)       # [n, N, S+1]

    fcfg = facade_mod.FacadeConfig(n_nodes=n, k=k, degree=min(2, n - 1),
                                   lr=lr)
    source = (draws if draws is not None else TorchDraws)(seed)
    params, heads_k = source.facade_init(binding, k, head_jitter)
    state = init_facade_state(binding, n, k, params=params, heads_k=heads_k,
                              device=dev)
    del params, heads_k

    rng = np.random.default_rng(0)
    evals = []
    t0 = time.time()
    for rnd in range(rounds):
        # draw(): the round's batches, then its topology
        idx = torch.from_numpy(rng.integers(
            0, train.shape[1], size=(n, local_steps, batch))).to(dev)
        batches = pipeline.sample_round_token_batches(idx, train)
        perms = source.perms(n, fcfg.degree).to(dev)
        # round(drawn)
        with device_mod.no_tf32():
            state, _ = facade_mod.facade_round(fcfg, binding, state,
                                               batches, perms)
        if (rnd + 1) % eval_every == 0 or rnd == 0:
            nll = evaluate(binding, state, data)
            rate = (rnd + 1) / (time.time() - t0)
            evals.append((rnd + 1, nll, state.cluster_id.clone(), rate))
            if verbose:
                print(f"round {rnd+1:4d}  per-cluster NLL {nll}  "
                      f"heads {state.cluster_id.tolist()}  "
                      f"({rate:.2f} rounds/s)", flush=True)
    return {"state": state, "evals": evals,
            "node_cluster": data["node_cluster"],
            "rounds_per_s": rounds / (time.time() - t0)}


def summary(out: dict) -> str:
    """The reference's closing lines."""
    return "\n".join([
        "\nfinal head assignment: "
        f"{out['state'].cluster_id.tolist()}",
        f"true clusters:         {out['node_cluster'].tolist()}"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--nodes", type=int, nargs="+", default=[3, 1])
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(summary(run(arch=args.arch, rounds=args.rounds, nodes=args.nodes,
                      seq=args.seq, batch=args.batch,
                      local_steps=args.local_steps, lr=args.lr,
                      eval_every=args.eval_every, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
