"""Batched serving driver: prefill a request batch, then decode N tokens
(the port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch llama3.2-1b --requests 8 \\
        --prompt-len 64 --gen-len 32 [--device cpu]

``main`` serves the SMOKE variant of an architecture with parameters from
the port's own init, as the reference does; ``serve`` is the request loop
for any config and parameters. Prompts are right-padded to
``prompt_len``; the first generated token is taken (greedily) from the
logits of the last padded position, and decoding continues at
``pos = len(prompt)``, as in the reference (``ROADMAP.md`` queue 3 records
that quirk). On the card, prefill runs every layer's attention or wkv
recurrence through the hand-written kernels; decode steps run neither.
The reference's ``--net`` and ``--trace-jsonl`` overlays are not ported
yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as _configs  # noqa: F401  (registry)
from repro_torch.device import resolve
from repro_torch.models import api, transformer
from repro_torch.models.base import get_config, list_archs


def make_requests(rng, n, prompt_len, vocab):
    """``n`` prompts of ``prompt_len // 2 .. prompt_len`` random tokens
    from numpy's generator (the reference's queue for the same seed)."""
    return [rng.integers(1, vocab, size=(rng.integers(
        prompt_len // 2, prompt_len + 1),)).astype(np.int32)
        for _ in range(n)]


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray        # [n_requests, gen_len] int32, queue order
    prefill_logits: list      # per batch: [b, V] fp32 CPU tensor
    batch_sizes: list         # per batch
    prefill_s: list           # per batch, host clock around a synchronised
    decode_s: list            # prefill / decode loop, seconds
    prompt_len: int
    gen_len: int
    finite: bool              # every prefill and decode logit was finite

    @property
    def prefill_tok_s(self) -> float:
        """Prompt positions (padding included) prefilled per second."""
        return sum(self.batch_sizes) * self.prompt_len / sum(self.prefill_s)

    @property
    def decode_tok_s(self) -> float:
        return sum(self.batch_sizes) * self.gen_len / sum(self.decode_s)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, queue, *, batch: int, prompt_len: int, gen_len: int,
          temperature: float = 0.0, seed: int = 0,
          device="cuda") -> ServeResult:
    """Serve ``queue`` (prompts of at most ``prompt_len`` tokens) in
    batches of ``batch``: prefill, then ``gen_len`` decode steps each.
    ``params`` lie on ``device``. Temperature sampling draws from a
    ``torch.Generator`` seeded with ``seed``; 0 is greedy."""
    device = resolve(device)
    queue = list(queue)
    cache_len = transformer.cache_physical_len(cfg, prompt_len + gen_len)
    gen = torch.Generator(device).manual_seed(seed)
    finite = torch.ones((), dtype=torch.bool, device=device)
    out, logits0, sizes, t_pre, t_dec = [], [], [], [], []
    while queue:
        batch_reqs, queue = queue[:batch], queue[batch:]
        b = len(batch_reqs)
        lens = np.array([len(r) for r in batch_reqs], np.int32)
        toks = np.zeros((b, prompt_len), np.int32)
        for i, r in enumerate(batch_reqs):
            toks[i, :len(r)] = r
        toks_d = torch.from_numpy(toks).to(device)

        _sync(device)
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(
            cfg, params, toks_d, cache_extra=cache_len - prompt_len)
        last = torch.argmax(logits, -1)
        _sync(device)
        t_pre.append(time.perf_counter() - t0)
        finite &= torch.isfinite(logits).all()
        logits0.append(logits.cpu())

        out_tokens = np.zeros((b, gen_len), np.int32)
        pos = torch.from_numpy(lens).to(device)  # next position per request
        t0 = time.perf_counter()
        for t in range(gen_len):
            out_tokens[:, t] = last.cpu().numpy()
            logits, cache = transformer.decode_step(cfg, params, cache,
                                                    last[:, None], pos)
            finite &= torch.isfinite(logits).all()
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                last = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                last = torch.argmax(logits, -1)
            pos = pos + 1
        _sync(device)
        t_dec.append(time.perf_counter() - t0)
        out.append(out_tokens)
        sizes.append(b)
    tokens = (np.concatenate(out) if out
              else np.zeros((0, gen_len), np.int32))
    return ServeResult(tokens=tokens, prefill_logits=logits0,
                       batch_sizes=sizes, prefill_s=t_pre, decode_s=t_dec,
                       prompt_len=prompt_len, gen_len=gen_len,
                       finite=bool(finite))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = api.init_params(cfg,
                             torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    queue = make_requests(rng, args.requests, args.prompt_len,
                          cfg.vocab_size)
    t0 = time.perf_counter()
    res = serve(cfg, params, queue, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                temperature=args.temperature, seed=args.seed, device=device)
    dt = time.perf_counter() - t0
    row = 0
    for b in res.batch_sizes:
        lens = [len(r) for r in queue[row:row + b]]
        print(f"batch of {b}: prompts {lens} -> {args.gen_len} tokens each "
              f"(first req head: {res.tokens[row, :8].tolist()})")
        row += b
    total_tok = len(queue) * args.gen_len
    print(f"served {len(queue)} requests, {total_tok} tokens in {dt:.1f}s "
          f"= {total_tok / dt:.1f} tok/s (prefill {res.prefill_tok_s:.1f} "
          f"tok/s, decode {res.decode_tok_s:.1f} tok/s, on {device})")


if __name__ == "__main__":
    main()
