"""Serve per-cluster FACADE models with batched requests, on the PyTorch
port.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

The port of ``examples/serve_batched.py``, the deployment story of the
paper: after decentralized training each cluster owns a specialized
model (shared core + its head). A serving tier routes each request to
its cluster's model and decodes with a KV cache. This example builds two
cluster models from one FACADE state, batches mixed-cluster requests,
groups them per cluster, prefills (attention through the flash-attention
kernel on the card, one launch a layer) and decodes greedily. Runs on
the NVIDIA card unless ``--device`` names another device; raises where
CUDA is missing.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.configs  # noqa: E402,F401  (registry)
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import split  # noqa: E402
from repro_torch.core.bindings import make_binding  # noqa: E402
from repro_torch.core.runner import TorchDraws  # noqa: E402
from repro_torch.core.state import init_facade_state  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.base import get_config  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def cluster_models(state, k: int) -> list:
    """One deployable model per cluster: the core of a member node and
    that node's head of the cluster."""
    models = []
    for c in range(k):
        node = int(torch.argmax((state.cluster_id == c).int()))
        core = tree_map(lambda l: l[node], state.cores)
        head = split.select_head(
            tree_map(lambda l: l[node:node + 1], state.heads),
            torch.tensor([c], device=state.cluster_id.device))
        models.append(split.merge_params(core, tree_map(lambda l: l[0],
                                                        head)))
    return models


def run(*, arch: str = "llama3.2-1b", cfg=None, n: int = 4, k: int = 2,
        clusters=(0, 0, 1, 1), n_requests: int = 8, prompt_len: int = 32,
        gen_len: int = 16, head_jitter: float = 0.05, seed: int = 0,
        device="cuda", draws=None) -> dict:
    """Build the FACADE state (a stand-in for a trained one), serve
    ``n_requests`` mixed-cluster requests per cluster; returns
    ``{"requests": [(cluster, prompt)], "generated": {cluster: [b,
    gen_len] tokens on the device}}``. ``cfg`` defaults to ``arch``'s
    smoke config; ``draws`` is a callable of the seed giving the source of
    the initial parameters (default ``TorchDraws``)."""
    dev = device_mod.resolve(device)
    cfg = cfg if cfg is not None else get_config(arch, smoke=True)
    binding = make_binding(cfg)
    source = (draws if draws is not None else TorchDraws)(seed)
    params, heads_k = source.facade_init(binding, k, head_jitter)
    state = init_facade_state(binding, n, k, params=params, heads_k=heads_k,
                              device=dev)
    del params, heads_k
    state = state._replace(cluster_id=torch.tensor(clusters, device=dev))
    models = cluster_models(state, k)
    del state

    # mixed request queue: (cluster_id, prompt tokens)
    rng = np.random.default_rng(0)
    requests = [(int(rng.integers(0, k)),
                 rng.integers(1, cfg.vocab_size, size=prompt_len)
                 .astype(np.int32)) for _ in range(n_requests)]

    generated = {}
    with torch.no_grad():
        for c in range(k):
            batch = [t for cc, t in requests if cc == c]
            if not batch:
                continue
            toks = torch.from_numpy(np.stack(batch)).to(dev)
            params = models[c]
            logits, cache = transformer.prefill(cfg, params, toks,
                                                cache_extra=gen_len)
            last = logits.argmax(-1).to(torch.int32)
            outs = [last]
            pos = torch.full((len(batch),), prompt_len, dtype=torch.int32,
                             device=dev)
            for _ in range(gen_len - 1):
                logits, cache = transformer.decode_step(
                    cfg, params, cache, last[:, None], pos)
                last = logits.argmax(-1).to(torch.int32)
                outs.append(last)
                pos = pos + 1
            generated[c] = torch.stack(outs, dim=1)
    return {"requests": requests, "generated": generated}


def summary(out: dict) -> str:
    """A line a cluster, as the reference prints them."""
    lines = []
    for c, gen in out["generated"].items():
        gen = gen.cpu().numpy()
        lines.append(f"cluster {c}: served {gen.shape[0]} requests; "
                     f"generated [{gen.shape[0]}, {gen.shape[1]}] tokens; "
                     f"first: {gen[0, :8].tolist()}")
    lines.append("\nall requests served with cluster-specialized models")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(summary(run(device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
