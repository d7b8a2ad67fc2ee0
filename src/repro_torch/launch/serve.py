"""Batched serving driver: prefill a request batch, then decode N tokens
(the port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch llama3.2-1b --requests 8 \\
        --prompt-len 64 --gen-len 32 [--device cpu] [--net edge-v2] \\
        [--trace-jsonl build/serve.jsonl]

``main`` serves the SMOKE variant of an architecture with parameters from
the port's own init, as the reference does; ``serve`` is the request loop
for any config and parameters. Both refuse an encoder-decoder config with
the reference's ``SystemExit``; a VLM is served text only. Prompts are right-padded to
``prompt_len``; the first generated token is taken (greedily) from the
logits of the last padded position, and decoding continues at
``pos = len(prompt)``, as in the reference (``ROADMAP.md`` queue 3 records
that quirk). On the card, prefill runs every layer's attention or wkv
recurrence through the hand-written kernels; decode steps run neither.

``--net PRESET`` lays a ``repro_torch.netsim`` link model over the served
traffic and adds an SLO line: each batch's prompt bytes in and streamed
response bytes out go through the preset's latency and bandwidth (its
worst link class under tiered presets: the clients are edge devices)
into a :class:`~repro_torch.comm.CommLog`, which gives the simulated
network seconds in total and to drain 50% and 100% of the queue.

``--trace-jsonl PATH`` attaches a :class:`~repro_torch.obs.Tracer` with a
:class:`~repro_torch.obs.JsonlSink`, in the training drivers' record
format: a ``prefill`` and a ``decode`` span a batch, a ``queue.wait``
event a batch (how long its requests waited since the queue arrived) and
a final ``slo`` event. A span ends on the host clock after the batch's
own synchronise (the timing of ``ServeResult``), so tracing adds no host
sync.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as _configs  # noqa: F401  (registry)
from repro_torch import netsim
from repro_torch.comm import CommLog
from repro_torch.device import resolve
from repro_torch.models import api, transformer
from repro_torch.models.base import get_config, list_archs
from repro_torch.obs import JsonlSink, Tracer
from repro_torch.obs.trace import span

TOKEN_BYTES = 4  # int32 token ids on the wire


def make_requests(rng, n, prompt_len, vocab):
    """``n`` prompts of ``prompt_len // 2 .. prompt_len`` random tokens
    from numpy's generator (the reference's queue for the same seed)."""
    return [rng.integers(1, vocab, size=(rng.integers(
        prompt_len // 2, prompt_len + 1),)).astype(np.int32)
        for _ in range(n)]


def wire_params(net) -> tuple:
    """``(latency_s, bandwidth_bps)`` of the client link: a tiered preset
    (``net.classes``) serves at its worst link class, the clients being
    the edge devices; any other at its uniform scalars."""
    if net.classes is None:
        return net.latency_s, net.bandwidth_bps
    cl = net.classes
    return (max(cl.core_latency_s, cl.edge_latency_s),
            min(cl.core_bandwidth_bps, cl.edge_bandwidth_bps))


def batch_net_seconds(net, prompt_bytes: float, gen_len: int,
                      response_bytes: float) -> float:
    """Simulated network seconds of one served batch: the prompts arrive
    in one transfer, then each decoded token streams back to its client,
    a latency a step plus the whole response's serialisation."""
    lat, bw = wire_params(net)
    upload = lat + 8.0 * prompt_bytes / bw
    stream = gen_len * lat + 8.0 * response_bytes / bw
    return float(upload + stream)


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
    wall_s: float = 0.0       # host seconds of the whole queue
    comm: "CommLog | None" = None  # under ``net``: bytes on the wire and
    #                         simulated seconds a batch, "accuracy" the
    #                         drained fraction of the queue

    @property
    def prefill_tok_s(self) -> float:
        """Prompt positions (padding included) prefilled per second."""
        return sum(self.batch_sizes) * self.prompt_len / sum(self.prefill_s)

    @property
    def decode_tok_s(self) -> float:
        return sum(self.batch_sizes) * self.gen_len / sum(self.decode_s)


def refuse_encdec(cfg) -> None:
    """The reference server's refusal of an encoder-decoder config."""
    if cfg.encoder_layers > 0:
        raise SystemExit("enc-dec serving: use examples/serve_batched.py "
                         "(audio frontend is stubbed)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, queue, *, batch: int, prompt_len: int, gen_len: int,
          temperature: float = 0.0, seed: int = 0, device="cuda", net=None,
          tracer=None) -> ServeResult:
    """Serve ``queue`` (prompts of at most ``prompt_len`` tokens) in
    batches of ``batch``: prefill, then ``gen_len`` decode steps each.
    ``params`` lie on ``device``. Temperature sampling draws from a
    ``torch.Generator`` seeded with ``seed``; 0 is greedy.

    ``net``: a ``netsim.NetworkConfig`` whose link model each batch's
    traffic goes through (``ServeResult.comm``). ``tracer``: an
    ``obs.Tracer`` given ``queue.wait`` events, ``prefill`` and
    ``decode`` spans and a final ``slo`` event."""
    refuse_encdec(cfg)
    device = resolve(device)
    queue = list(queue)
    n_requests = len(queue)
    cache_len = transformer.cache_physical_len(cfg, prompt_len + gen_len)
    gen = torch.Generator(device).manual_seed(seed)
    finite = torch.ones((), dtype=torch.bool, device=device)
    comm = CommLog() if net is not None else None
    out, logits0, sizes, t_pre, t_dec = [], [], [], [], []
    t_start = time.perf_counter()
    while queue:
        if tracer is not None:
            # every request arrived at the start, so a batch's wait is how
            # long serving the batches before it took
            tracer.event("queue.wait", batch=len(sizes),
                         wait_s=time.perf_counter() - t_start,
                         queued=len(queue))
        batch_reqs, queue = queue[:batch], queue[batch:]
        b = len(batch_reqs)
        lens = np.array([len(r) for r in batch_reqs], np.int32)
        toks = np.zeros((b, prompt_len), np.int32)
        for i, r in enumerate(batch_reqs):
            toks[i, :len(r)] = r
        toks_d = torch.from_numpy(toks).to(device)

        _sync(device)
        with span(tracer, "prefill", batch=len(sizes), size=b):
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
        with span(tracer, "decode", batch=len(sizes), size=b,
                  steps=gen_len):
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
        if comm is not None:
            # prompts in and streamed tokens out through the preset's link
            # model; "accuracy" is the drained fraction of the queue, so
            # seconds_to_target(f) is the simulated time to serve f of it
            prompt_bytes = float(lens.sum()) * TOKEN_BYTES
            response_bytes = float(b * gen_len) * TOKEN_BYTES
            comm.record(len(sizes), prompt_bytes + response_bytes,
                        acc=sum(sizes) / n_requests,
                        round_s=batch_net_seconds(net, prompt_bytes,
                                                  gen_len, response_bytes))
    wall = time.perf_counter() - t_start
    tokens = (np.concatenate(out) if out
              else np.zeros((0, gen_len), np.int32))
    if tracer is not None:
        total_tok = sum(sizes) * gen_len
        tracer.event(
            "slo", requests=sum(sizes), tokens=total_tok, wall_s=wall,
            tok_s=total_tok / wall,
            net=net.name if net is not None else None,
            sim_net_s=comm.total_hours * 3600 if comm is not None else 0.0,
            rollup=tracer.rollup()["spans"])
    return ServeResult(tokens=tokens, prefill_logits=logits0,
                       batch_sizes=sizes, prefill_s=t_pre, decode_s=t_dec,
                       prompt_len=prompt_len, gen_len=gen_len,
                       finite=bool(finite), wall_s=wall, comm=comm)


def slo_line(net, comm: CommLog) -> str:
    """The reference server's SLO line: simulated network seconds in
    total and to drain 50% and 100% of the queue."""
    def drain(v):       # None: that drained fraction was never reached
        return "not reached" if v is None else f"{v:.3f}s"

    return (f"SLO [{net.name}]: {comm.total_hours * 3600:.3f} simulated "
            f"network seconds total ({comm.total_hours:.6f} h, "
            f"{comm.total_gb * 1e3:.3f} MB on the wire); p50 queue drain "
            f"{drain(comm.seconds_to_target(0.5))}, full drain "
            f"{drain(comm.seconds_to_target(1.0))}")


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
    ap.add_argument("--net", default=None, choices=sorted(netsim.PRESETS),
                    help="netsim preset overlay: report simulated network "
                         "time (CommLog total_hours / seconds_to_target) "
                         "next to the real tok/s")
    ap.add_argument("--trace-jsonl", default=None,
                    help="write tracer spans and events (prefill / decode "
                         "/ queue.wait / slo) to this JSONL file")
    args = ap.parse_args(argv)

    tracer = None
    if args.trace_jsonl:
        tracer = Tracer(sink=JsonlSink(args.trace_jsonl))
    net = netsim.NetworkConfig.preset(args.net) if args.net else None

    device = resolve(args.device)
    cfg = get_config(args.arch, smoke=True)
    refuse_encdec(cfg)
    params = api.init_params(cfg,
                             torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    queue = make_requests(rng, args.requests, args.prompt_len,
                          cfg.vocab_size)
    t0 = time.perf_counter()
    res = serve(cfg, params, queue, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                temperature=args.temperature, seed=args.seed, device=device,
                net=net, tracer=tracer)
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
    if net is not None:
        print(slo_line(net, res.comm))
    if tracer is not None:
        tracer.sink.close()
        print(f"trace: {tracer.sink.n_emitted} records -> "
              f"{tracer.sink.path}")


if __name__ == "__main__":
    main()
