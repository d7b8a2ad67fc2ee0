"""Training launcher (the port of ``repro.launch.train``).

Two modes:

* ``paper`` (default) — the paper's experiments: FACADE / EL / D-PSGD /
  DEPRL / DAC over a synthetic clustered dataset with feature skew, on
  GN-LeNet or ResNet8:

      python -m repro_torch.launch.train --algo facade --clusters 30 2 \\
          --rounds 200 --k 2 [--model resnet8] [--device cpu]

* ``lm`` — one-process LM pretraining of an architecture's SMOKE variant
  on a synthetic clustered token stream, with AdamW and a checkpoint:

      python -m repro_torch.launch.train --mode lm --arch llama3.2-1b \\
          --steps 200 --batch 8 --seq 256 [--ckpt PATH] [--device cpu]

Both run on the card unless ``--device cpu`` is given. As in the
reference, ``--smoke`` is a ``store_true`` flag whose default is already
True, so the command line always builds the smoke CNN (``ROADMAP.md``
queue 3 records this); :func:`paper_main` honours a namespace whose
``smoke`` is False. ``--test-per-class`` (the test set's size per class
and cluster, ``SynthSpec``'s default 32) is the port's own flag.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch import configs as _configs  # noqa: F401  (registry)
from repro_torch import optim
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.facade_paper import lenet, resnet8
from repro_torch.core.runner import ALGOS, run_experiment
from repro_torch.data import tokens as tokens_mod
from repro_torch.data.synthetic import SynthSpec, make_clustered_data
from repro_torch.device import resolve
from repro_torch.models import api
from repro_torch.models.base import get_config, list_archs
from repro_torch.tree import tree_leaves, tree_unflatten


def paper_main(args):
    """One experiment from ``args``; prints the reference's JSON summary
    (and with ``args.out`` appends its record) and returns the
    ``RunResult``."""
    spec = SynthSpec(n_classes=args.n_classes, image_size=args.image_size,
                     samples_per_class=args.samples_per_class,
                     test_per_class=args.test_per_class, seed=args.seed)
    transforms = args.transforms or None
    ds = make_clustered_data(spec, tuple(args.clusters), transforms)
    cfg = (resnet8(smoke=args.smoke) if args.model == "resnet8"
           else lenet(smoke=args.smoke))
    cfg = cfg.replace(n_classes=args.n_classes, image_size=args.image_size)

    res = run_experiment(
        args.algo, cfg, ds, rounds=args.rounds, k=args.k,
        degree=args.degree, local_steps=args.local_steps,
        batch_size=args.batch, lr=args.lr, eval_every=args.eval_every,
        seed=args.seed, warmup_rounds=args.warmup_rounds,
        target_acc=args.target_acc, verbose=True, device=args.device)

    print(json.dumps({
        "algo": args.algo, "clusters": args.clusters,
        "final_acc_per_cluster": res.final_acc,
        "best_fair_acc": res.best_fair_acc(),
        "dp": res.dp, "eo": res.eo,
        "total_gb": res.comm.total_gb,
    }, indent=2))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps({
                "algo": args.algo, "clusters": args.clusters,
                "acc_hist": res.acc_per_cluster, "fair_hist": res.fair_acc,
                "dp": res.dp, "eo": res.eo,
                "comm": {"rounds": res.comm.rounds, "bytes": res.comm.bytes,
                         "acc": res.comm.acc}}) + "\n")
    return res


def make_train_step(cfg, opt: optim.Optimizer):
    """``step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``: one gradient step of ``api.loss_fn`` with ``opt``."""
    def step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = api.loss_fn(cfg, tree_unflatten(params, leaves),
                                        batch)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            ups, opt_state = opt.update(tree_unflatten(params, list(grads)),
                                        opt_state, params)
            params = optim.apply_updates(params, ups)
        return (params, opt_state, loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    return step


def lm_extras(cfg, batch: int, device) -> dict:
    """The stub inputs lm mode adds to each batch, as the reference's:
    zero image embeddings ``[batch, n_image_tokens, d_model]`` for a VLM,
    zero frames ``[batch, encoder_seq, d_model]`` for an
    encoder-decoder, in the param dtype."""
    out = {}
    if cfg.arch_type == "vlm":
        out["img_embeds"] = torch.zeros(
            (batch, cfg.n_image_tokens, cfg.d_model), dtype=cfg.dt,
            device=device)
    if cfg.encoder_layers > 0:
        out["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                    dtype=cfg.dt, device=device)
    return out


def lm_main(args) -> dict:
    """Pretrain ``args.arch``'s smoke config for ``args.steps`` steps;
    returns ``{"params", "losses"}`` (the final params and each step's
    loss)."""
    device = resolve(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = api.init_params(cfg,
                             torch.Generator(device).manual_seed(args.seed))
    opt = optim.adamw(args.lr)
    opt_state = opt.init(params)

    tspec = tokens_mod.TokenSpec(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq + 1, seed=args.seed)
    stream = tokens_mod.make_clustered_tokens(
        tspec, (1,), seqs_per_node=args.steps * args.batch)
    train = stream["train"][0]  # [N, S+1]
    train_step = make_train_step(cfg, opt)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        rows = train[step * args.batch:(step + 1) * args.batch]
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in tokens_mod.lm_batch(rows).items()}
        batch.update(lm_extras(cfg, args.batch, device))
        params, opt_state, loss, metrics = train_step(params, opt_state,
                                                      batch)
        losses.append(loss)
        if (step + 1) % args.log_every == 0 or step == 0:
            print(f"step {step+1:5d}  loss {float(loss):.4f}  "
                  f"acc {float(metrics['acc']):.3f}  "
                  f"{(step+1)/(time.time()-t0):.2f} it/s", flush=True)
    if args.ckpt:
        ckpt_io.save(args.ckpt, {"params": params, "step": args.steps})
        print(f"checkpoint -> {args.ckpt}")
    return {"params": params, "losses": [float(l) for l in losses]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("paper", "lm"), default="paper")
    # paper mode
    ap.add_argument("--algo", default="facade", choices=ALGOS)
    ap.add_argument("--model", default="lenet", choices=("lenet", "resnet8"))
    ap.add_argument("--clusters", type=int, nargs="+", default=[30, 2])
    ap.add_argument("--transforms", nargs="+", default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--warmup-rounds", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--target-acc", type=float, default=None)
    ap.add_argument("--n-classes", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--samples-per-class", type=int, default=16)
    ap.add_argument("--test-per-class", type=int,
                    default=SynthSpec.test_per_class)
    ap.add_argument("--smoke", action="store_true", default=True)
    # lm mode
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    # shared
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return (lm_main if args.mode == "lm" else paper_main)(args)


if __name__ == "__main__":
    main()
