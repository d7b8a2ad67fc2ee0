#!/usr/bin/env python3
"""The language models' meshes on four cards: data and model axes over
ranks, each card's K2 and K3 on its own heads.

    torchrun --nproc-per-node 4 tools/lm_mesh_run.py [--out FILE]
    python -m torch.distributed.run --nproc-per-node 4 tools/lm_mesh_run.py

One process a card (``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; NCCL). Every step is built by ``launch.steps.build_case``
(``mesh=``: DTensor arguments laid out by ``launch.shardings``, the
reference's activation hooks) and held against the same step with
``mesh=None`` on rank 0's card, from the same seed (the other ranks wait
at a barrier); the meshed outputs are gathered whole on every rank.

1. llama3.2-1b at full width in fp32 on ``make_debug_mesh((2, 2),
   ("data", "model"))``: ``prefill_32k`` and ``decode_32k`` (logits within
   ``LOGIT_TOL`` of the largest |logit|) and ``train_4k`` with remat (one
   AdamW step: the new parameters within ``TRAIN_TOL`` where |g| > 1e-6,
   within two steps of the learning rate elsewhere; the loss within
   ``TRAIN_TOL``; the moments by a float64 witness: rank 0 computes the
   step's gradient at float64 from the same draw (the model's fp32
   upcasts kept at float64), and the meshed step's moments must lie no
   farther from the moments of that gradient than ``WITNESS_FACTOR``
   times the one-card fp32 step's do, while a bf16 gradient (the
   control) lies farther than that), at the batches of ``LLAMA``; K2 16
   times a prefill on every rank. One bf16 prefill, meshed and on one card: the
   largest difference and whether the greedy tokens agree are recorded,
   finiteness gated.
2. rwkv6-1.6b ``prefill_32k`` in fp32 on the same mesh, by the same rule;
   K3 24 times a prefill on every rank.
3. llava-next-34b on ``make_debug_mesh((1, 4), ("data", "model"))``:
   (a) 16 of its 60 layers in fp32, a prefill of 2,880 image and 512 text
   positions at batch 4 (``chip_smoke.VLM_PREFILL``'s shape), meshed
   against one card by the rule of 1; (b) the whole model, 60 layers in
   bf16, its parameters drawn on every rank in ``init_params``' order one
   layer at a time and cut to the rank's shards
   (``steps.init_params_on_mesh``, so no card holds the whole model), the
   same prefill and 32 greedy decode steps: finite logits, 60 K2 launches
   a prefill on each rank, each card's peak memory, prefill and decode
   tokens per second (host clock around synchronised calls) and the NCCL
   kernels' share of a profiled prefill's device time.
4. llama3.2-1b's FACADE step (``steps.build_facade_case``) at full width
   in fp32 on ``make_debug_mesh((2, 1, 2), ("pod", "data", "model"))``,
   the multi-pod layout, at ``FACADE``'s batch and length (n 2, k 2,
   degree 1, one local step; the heads jittered apart, so that step 2c's
   choice is no tie): each pod's two ranks run their own node.
   Against ``mesh=None`` on rank 0: the selection losses within
   ``LOGIT_TOL`` of the largest, every leaf of the new state within
   ``STATE_TOL`` of its largest value, the cluster ids equal (the margin
   between each node's two heads' losses recorded); K1 once and K2 16
   times (one node's feature pass) on every rank by counter and by the
   profiler's kernel names; the step's seconds (the second call, host
   clock around a synchronised call), peak memory a card and the NCCL
   kernels' share of a profiled step's device time.
5. hymba-1.5b's prefill at full width in fp32 (``HYMBA``'s batch and
   prompt) on the (data 2, model 2) mesh of 1, where its 25 query and 5
   kv heads do not divide the model axis (K2 gathers q along S), against
   one card by the rule of 1; K2 32 times (its layers) on every rank by
   counter and by kernel name.

``--only`` runs the named cases alone (``llama``, ``bf16``, ``rwkv``,
``llava``, ``whole``, ``facade``, ``hymba``). Rank 0 prints each card's name and power limit, then one JSON object
(also written to ``--out``). Exits non-zero when a check fails; the
process group is taken down within a bounded time.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import gc
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# each rank holds the whole outputs of a meshed step beside rank 0's
# one-card step: fewer stranded blocks
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models.base import get_config  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

LOGIT_TOL = 1e-4        # of the largest |logit|, fp32
TRAIN_TOL = 1e-5        # tests/test_torch_steps.py's rule
LR = 3e-4
B1, B2 = 0.9, 0.95      # steps.make_optimizer's AdamW (optim.adamw's)
# the meshed step's moments lie no farther from the float64 step's than
# this many times the one-card fp32 step's: both sum in fp32, in two orders
WITNESS_FACTOR = 2.0
# (input shape, batch): llama3.2-1b fp32 on (2, 2); the batches are cut so
# that one card also holds the mesh=None step (train: the plain
# attention's [B, 32, 4096, 4096] fp32 scores)
LLAMA = (("prefill_32k", 4), ("decode_32k", 4), ("train_4k", 2))
RWKV_BATCH = 2
LLAVA_LAYERS = 16
GEN = 32
STATE_TOL = 1e-5        # FACADE's new state, of each leaf's largest value
# FACADE's step: a node's batch and length, cut from the reference's B 16
# of S 4096 (src/repro/launch/steps.py:220): one card also holds the
# mesh=None step in fp32 (chip_smoke.py's steps_phase peaks at 69.77 GB
# on one H100 at B 4 of S 4096 in bf16). Step 2c runs K1's fp32 tiled
# body (K1's FMA body, which it ran before, took 24.8 s a rank's call at
# T 2048; tools/kernel_ab.py --library): T 512 a node
FACADE = dict(n_nodes=2, batch_per_node=2, seq=256, head_jitter=0.1)
# hymba-1.5b's prefill: chip_smoke's serving batch and prompt
HYMBA = dict(batch=4, seq=512)
CASES = ("llama", "bf16", "rwkv", "llava", "whole", "facade", "hymba")


def rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want| (``got`` brought to
    ``want``'s device)."""
    scale = max(float(want.abs().max()), 1e-30)
    diff = got.to(want.device, torch.float64) - want.to(torch.float64)
    return float(diff.abs().max()) / scale


def to_host(parts):
    """A step's whole outputs (lists of leaves) moved to host memory."""
    return [[x.cpu() for x in part] for part in parts]


@contextlib.contextmanager
def keep_wide():
    """``Tensor.float()`` leaves a float64 tensor as it is: the model's
    fp32 upcasts (norms, softmax, logits) stay float64 in a float64 run."""
    orig = torch.Tensor.float

    def wide(self, *args, **kwargs):
        if self.dtype == torch.float64:
            return self
        return orig(self, *args, **kwargs)

    torch.Tensor.float = wide
    try:
        yield
    finally:
        torch.Tensor.float = orig


def grads_at(arch, shape, batch, cfg, dtype) -> list:
    """One card's gradient of the train step's loss (remat, as
    ``build_case``'s) at seed 0's draw and batch, the parameters cast from
    fp32 to ``dtype`` and the model run at it (float64: ``keep_wide``) ->
    its leaves in ``tree_leaves`` order."""
    case = steps.build_case(arch, shape, batch=batch, cfg=cfg, seed=0)
    params, opt_state, data = case.args
    del case, opt_state
    leaves = [x.detach().to(dtype).requires_grad_()
              for x in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    del params
    wide = keep_wide() if dtype == torch.float64 else \
        contextlib.nullcontext()
    with wide:
        loss, _ = api.loss_fn(cfg.replace(dtype=str(dtype).split(".")[-1]),
                              p, data, remat=True)
        grads = torch.autograd.grad(loss, leaves)
    return [g.detach() for g in grads]


def moments_err(m, v, g64) -> float:
    """The largest ``rel_err`` of the first AdamW step's moments ``m`` and
    ``v`` (leaf lists) against those of the float64 gradient ``g64``."""
    return max(max(rel_err(a, (1 - B1) * g), rel_err(b, (1 - B2) * g * g))
               for a, b, g in zip(m, v, g64, strict=True))


def train_witness(arch, shape, batch, cfg, got, want) -> dict:
    """The train step's moments, meshed (``got``) and on one card
    (``want``: whole outputs on the host), against a float64 step's from
    the same draw; the control is a bf16 step's."""
    t0 = time.perf_counter()
    g64 = grads_at(arch, shape, batch, cfg, torch.float64)
    n = len(g64)
    mesh_err = moments_err(got[1][:n], got[1][n:], g64)
    one_err = moments_err(want[1][:n], want[1][n:], g64)
    gbf = grads_at(arch, shape, batch, cfg, torch.bfloat16)
    ctrl_err = moments_err([(1 - B1) * g.float() for g in gbf],
                           [(1 - B2) * g.float().square() for g in gbf], g64)
    del g64, gbf
    limit = WITNESS_FACTOR * one_err
    return {"mesh_vs_f64": mesh_err, "one_card_vs_f64": one_err,
            "bf16_control_vs_f64": ctrl_err, "limit": limit,
            "seconds": time.perf_counter() - t0,
            "ok": mesh_err <= limit < ctrl_err}


def run_step(arch, shape, batch, cfg, mesh, seq=None, by_name=()):
    """One step from seed 0 (``seq`` positions, default the shape's); ->
    (each output's tensor leaves, whole; launches; seconds). With
    ``by_name``, the step is run once more under the profiler and the
    launches get the device kernels whose names hold each string."""
    case = steps.build_case(arch, shape, batch=batch, cfg=cfg, seq=seq,
                            seed=0, mesh=mesh)
    torch.cuda.synchronize()
    with cs.counted() as counts:
        t0 = time.perf_counter()
        out = case.step_fn(*case.args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    parts = [cs.whole_leaves([part]) for part in out]
    del out
    if by_name:
        prof = cs.device_profile(lambda: case.step_fn(*case.args),
                                 kernels=by_name)
        counts["profiled"] = {k: v[0] for k, v in prof["kernels"].items()}
    del case
    return parts, counts, wall


def compare(kind, got, want) -> dict:
    """The meshed step's whole outputs against mesh=None's."""
    if kind != "train":
        logit = rel_err(got[0][0], want[0][0])
        rest = max((rel_err(g, w) for g, w in zip(sum(got[1:], []),
                                                  sum(want[1:], []))),
                   default=0.0)
        return {"logit_rel_err": logit, "cache_rel_err": rest,
                "ok": logit <= LOGIT_TOL}
    params, opt, metrics = got
    w_params, w_opt, w_metrics = want
    n = len(w_params)
    bad, worst = 0, 0.0
    for g, w, m in zip(params, w_params, w_opt[:n]):
        big = (m / 0.1).abs() > 1e-6
        diff = (g.to(w.device, torch.float32) - w.float()).abs()
        tol = TRAIN_TOL + TRAIN_TOL * w.float().abs()
        bad += int((diff[big] > tol[big]).sum())
        worst = max(worst, float(diff.max()))
    moments = max(rel_err(g, w) for g, w in zip(opt, w_opt))
    loss = abs(float(metrics[0]) - float(w_metrics[0]))
    return {"params_outside_tol": bad, "params_max_abs": worst,
            "moments_rel_err": moments, "ce_abs_err": loss,
            "ok": bad == 0 and worst <= 2 * LR
            and loss <= TRAIN_TOL * max(1.0, abs(float(w_metrics[0])))}


def guarded(name, fn, *args):
    """``fn(*args)``, or where it raises (on every rank alike: the ranks
    run the same program) a failed record with the error, so that the
    later cases still run."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001  (recorded, the run goes on)
        import traceback
        traceback.print_exc()
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        return {"ok": False, "error": f"{name}: {type(e).__name__}: {e}"}


def held(arch, shape, batch, cfg, mesh, rank, world, want_launches,
         seq=None, by_name=None):
    """A meshed step on every rank against mesh=None on rank 0; with
    ``by_name`` (kernel name -> launches a step), also the launches by the
    profiler's kernel names on every rank."""
    kind = steps.INPUT_SHAPES[shape].kind
    got, counts, wall = run_step(arch, shape, batch, cfg, mesh, seq,
                                 tuple(by_name or ()))
    every = [None] * world
    dist.all_gather_object(every, counts)
    res = None
    if rank == 0:
        if kind == "train":             # room for the one-card steps
            got = to_host(got)
            gc.collect()
            torch.cuda.empty_cache()
        want, one_counts, one_wall = run_step(arch, shape, batch, cfg, None,
                                              seq)
        res = compare(kind, got, want)
        res.update(batch=batch, dtype=str(cfg.dt), launches_by_rank=every,
                   mesh_s=wall, one_card_s=one_wall,
                   one_card_launches=one_counts,
                   finite=all(bool(torch.isfinite(x.float()).all())
                              for x in sum(got, [])))
        if seq is not None:
            res["positions"] = seq
        by_name = by_name or {}
        res["ok"] = res["ok"] and res["finite"] and all(
            {k: v for k, v in c.items() if k != "profiled"} == want_launches
            and c.get("profiled", {}) == by_name for c in every)
        if kind == "train":
            want = to_host(want)
            gc.collect()
            torch.cuda.empty_cache()
            res["witness"] = train_witness(arch, shape, batch, cfg, got,
                                           want)
            res["ok"] = res["ok"] and res["witness"]["ok"]
        print(json.dumps({f"{arch} {shape}": res}), flush=True)
        del want
    del got
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def bf16_prefill(mesh, rank, world) -> dict | None:
    """llama3.2-1b's bf16 prefill, meshed and on one card: recorded."""
    cfg = steps.resolve_config("llama3.2-1b", "prefill_32k")
    got, counts, _ = run_step("llama3.2-1b", "prefill_32k", 4, cfg, mesh)
    res = None
    if rank == 0:
        want, _, _ = run_step("llama3.2-1b", "prefill_32k", 4, cfg, None)
        res = {"logit_max_abs_diff": float(
            (got[0][0].float() - want[0][0].float()).abs().max()),
            "logit_rel_err": rel_err(got[0][0], want[0][0]),
            "greedy_equal": bool(torch.equal(got[0][0].argmax(-1),
                                             want[0][0].argmax(-1))),
            "finite": bool(torch.isfinite(got[0][0].float()).all()),
            "launches": counts}
        res["ok"] = res["finite"]
        print(json.dumps({"llama3.2-1b prefill_32k bf16": res}), flush=True)
    del got
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def llava_inputs(cfg, b):
    s = cs.VLM_PREFILL["prompt_len"]
    g = torch.Generator("cuda").manual_seed(1)
    img = (cs.VLM_PREFILL["img_std"] * torch.randn(
        (b, cfg.n_image_tokens, cfg.d_model), generator=g,
        device="cuda")).to(cfg.dt)
    toks = torch.randint(1, cfg.vocab_size, (b, s), generator=g,
                         device="cuda", dtype=torch.int32)
    return img, toks


def llava_whole(mesh, rank, world) -> dict:
    """llava-next-34b's 60 layers on (1, 4): prefill and GEN decode
    steps (module docstring, 3b)."""
    from repro_torch.models import hooks
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config("llava-next-34b")
    b = cs.VLM_PREFILL["batch"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.init_params_on_mesh(
        cfg, torch.Generator("cuda").manual_seed(0), mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    img, toks = llava_inputs(cfg, b)
    n_pos = cfg.n_image_tokens + toks.shape[1]
    axes = steps._hook_axes(mesh, True, False, "prefill", cfg)

    def prefill():
        with hooks.installed(*axes), implicit_replication():
            return transformer.prefill(cfg, params, toks, img_embeds=img,
                                       cache_extra=GEN)

    with torch.no_grad():
        logits, cache = prefill()                       # warm-up
        del logits, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with cs.counted() as pre_counts:
            t0 = time.perf_counter()
            logits, cache = prefill()
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        full = logits.full_tensor()
        finite = bool(torch.isfinite(full).all())
        pos = torch.full((b,), n_pos, dtype=torch.int32, device="cuda")
        tokens = []
        with cs.counted() as dec_counts:
            t0 = time.perf_counter()
            for _ in range(GEN):
                last = full.argmax(-1)
                tokens.append(last)
                with hooks.installed(*axes), implicit_replication():
                    logits, cache = transformer.decode_step(
                        cfg, params, cache, last[:, None].int(), pos)
                full = logits.full_tensor()
                finite = finite and bool(torch.isfinite(full).all())
                pos = pos + 1
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del logits, cache
        prof = cs.device_profile(prefill, kernels=(cs.NCCL_KERNEL,
                                                   "fa_bf16_kernel",
                                                   "fa_kernel"))
    nccl_events, nccl_s = prof["kernels"][cs.NCCL_KERNEL]
    res = {"layers": cfg.n_layers, "batch": b, "positions": n_pos,
           "gen": GEN, "init_s": init_s, "init_peak_bytes": init_peak,
           "weights": "init_params' draw, each layer drawn whole on every "
                      "rank and cut to its shards (steps.init_params_on_mesh)",
           "param_bytes_per_rank": sum(
               x.to_local().numel() * x.element_size()
               for x in tree_leaves(params)),
           "prefill_s": prefill_s, "prefill_tok_s": b * n_pos / prefill_s,
           "decode_s": decode_s, "decode_tok_s": b * GEN / decode_s,
           "peak_bytes": peak, "finite": finite,
           "launches": pre_counts, "decode_launches": dec_counts,
           "nccl_kernels": nccl_events, "nccl_s": nccl_s,
           "device_busy_s": prof["device_busy_s"],
           "nccl_share_of_busy": (None if not prof["device_busy_s"] else
                                  nccl_s / prof["device_busy_s"]),
           "top_kernels_s": prof["top_kernels_s"],
           "first_tokens": torch.stack(tokens, 1)[:, :8].tolist()}
    res["ok"] = finite and pre_counts["flash_attention"] == cfg.n_layers
    every = [None] * world
    dist.all_gather_object(every, res)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return every


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "lm_mesh_run.json")
    ap.add_argument("--llava-layers", type=int, default=LLAVA_LAYERS,
                    help="layers of llava-next-34b's meshed prefill held "
                         "against one card")
    ap.add_argument("--only", default=",".join(CASES),
                    help="the cases to run, comma-separated (of "
                         f"{', '.join(CASES)})")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(CASES):
        raise SystemExit(f"lm_mesh_run: unknown cases "
                         f"{sorted(only - set(CASES))}")
    if not torch.cuda.is_available():
        raise SystemExit("lm_mesh_run: CUDA is not available")
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                            timeout=datetime.timedelta(seconds=600))
    rank, world = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(local), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    smis = [None] * world
    dist.all_gather_object(smis, smi)
    if rank == 0:
        for s in smis:
            print(s, flush=True)
    if local == 0:
        build.build("flash_attention", "wkv", "head_select")
    dist.barrier()
    t_all = time.perf_counter()
    rec = {"nvidia_smi_by_rank": smis, "world": world,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "cases": {}}
    ok = True
    data = min(2, world)            # one card rehearses it at (1, 1)
    mesh = make_debug_mesh((data, world // data), ("data", "model"))
    llama = steps.resolve_config("llama3.2-1b", "prefill_32k").replace(
        dtype="float32")
    for shape, batch in LLAMA if "llama" in only else ():
        want = llama.n_layers if shape == "prefill_32k" else 0
        res = guarded(shape, held, "llama3.2-1b", shape, batch, llama,
                      mesh, rank, world, {"head_losses": 0,
                                          "flash_attention": want,
                                          "wkv": 0, "wkv_backward": 0})
        if rank == 0:
            rec["cases"][f"llama3.2-1b {shape}"] = res
            ok = ok and res["ok"]
    if "bf16" in only:
        res = guarded("bf16", bf16_prefill, mesh, rank, world)
        if rank == 0:
            rec["cases"]["llama3.2-1b prefill_32k bf16"] = res
            ok = ok and res["ok"]
    if "rwkv" in only:
        rwkv = steps.resolve_config("rwkv6-1.6b", "prefill_32k").replace(
            dtype="float32")
        res = guarded("rwkv", held, "rwkv6-1.6b", "prefill_32k",
                      RWKV_BATCH, rwkv, mesh, rank, world,
                      {"head_losses": 0, "flash_attention": 0,
                       "wkv": rwkv.n_layers, "wkv_backward": 0})
        if rank == 0:
            rec["cases"]["rwkv6-1.6b prefill_32k"] = res
            ok = ok and res["ok"]
    if "facade" in only:
        pods = min(2, world)
        mesh_pod = make_debug_mesh((pods, 1, world // pods),
                                   ("pod", "data", "model"))
        res = guarded("facade", facade_pod, mesh_pod, rank, world)
        if rank == 0:
            rec["cases"]["llama3.2-1b facade_pod"] = res
            ok = ok and res["ok"]
    if "hymba" in only:
        hymba = get_config("hymba-1.5b").replace(dtype="float32")
        res = guarded("hymba", held, "hymba-1.5b", "prefill_32k",
                      HYMBA["batch"], hymba, mesh, rank, world,
                      {"head_losses": 0, "flash_attention": hymba.n_layers,
                       "wkv": 0, "wkv_backward": 0}, HYMBA["seq"],
                      {"fa_kernel": hymba.n_layers, "fa_bf16_kernel": 0})
        if rank == 0:
            rec["cases"]["hymba-1.5b prefill"] = res
            ok = ok and res["ok"]
    mesh4 = make_debug_mesh((1, world), ("data", "model"))
    llava = get_config("llava-next-34b").replace(
        n_layers=args.llava_layers, dtype="float32")
    if "llava" in only:
        res = guarded("llava", llava_slice, llava, mesh4, rank, world)
        if rank == 0:
            rec["cases"][f"llava-next-34b {llava.n_layers} layers "
                         "prefill"] = res
            ok = ok and res["ok"]
    if "whole" in only:
        every = guarded("llava whole", llava_whole, mesh4, rank, world)
        if isinstance(every, dict):         # failed: the error
            every = [every]
        if rank == 0:
            rec["cases"]["llava-next-34b whole"] = every
            ok = ok and all(r["ok"] for r in every)
            print(json.dumps({"llava-next-34b whole": every[0]}), flush=True)
    if rank == 0:
        rec["ok"] = ok
        rec["total_s"] = time.perf_counter() - t_all
        text = json.dumps(rec, indent=1)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
        print(json.dumps({"ok": ok, "total_s": rec["total_s"]}), flush=True)
    flags = [None] * world
    dist.all_gather_object(flags, ok)
    return 0 if flags[0] else 1


def llava_slice(llava, mesh4, rank, world):
    """llava-next-34b's first layers in fp32 on (1, 4) against one card
    (module docstring, 3a)."""
    seq = llava.n_image_tokens + cs.VLM_PREFILL["prompt_len"]
    b = cs.VLM_PREFILL["batch"]
    got, counts, wall = run_step("llava-next-34b", "prefill_32k", b, llava,
                                 mesh4, seq)
    every = [None] * world
    dist.all_gather_object(every, counts)
    res = None
    if rank == 0:
        want, one_counts, one_wall = run_step("llava-next-34b",
                                              "prefill_32k", b, llava,
                                              None, seq)
        res = compare("prefill", got, want)
        res.update(layers=llava.n_layers, batch=b, positions=seq,
                   dtype="float32", launches_by_rank=every, mesh_s=wall,
                   one_card_s=one_wall)
        res["ok"] = res["ok"] and all(
            c["flash_attention"] == llava.n_layers for c in every)
        print(json.dumps({f"llava-next-34b {llava.n_layers} layers": res}),
              flush=True)
        del want
    del got
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def facade_step(mesh, cfg):
    """llama3.2-1b's FACADE step (``FACADE``) on ``mesh`` or one card from
    seed 0: (its case, its output)."""
    case = steps.build_facade_case("llama3.2-1b", cfg=cfg, seed=0,
                                   mesh=mesh, **FACADE)
    return case, case.step_fn(*case.args)


def facade_whole(out) -> dict:
    """A FACADE step's new state and info, every tensor whole (gathered
    on every rank, kept on rank 0's host)."""
    from torch.distributed.tensor import DTensor

    def whole(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return x.detach().cpu() if dist.get_rank() == 0 else None

    state, info = out
    return {"leaves": [whole(x) for x in tree_leaves(state.cores)
                       + tree_leaves(state.heads)],
            "cluster_id": whole(state.cluster_id),
            "losses": whole(info["selection_losses"]),
            "info_cluster_id": whole(info["cluster_id"]),
            "round_bytes": float(info["round_bytes"])}


def facade_pod(mesh, rank, world) -> dict | None:
    """llama3.2-1b's FACADE step on the multi-pod layout against
    mesh=None on rank 0 (module docstring, 4)."""
    cfg = get_config("llama3.2-1b").replace(dtype="float32")
    k1_name = cs.K1_BODY_KERNEL[cs.hs_ops.body_for(
        1, 1, FACADE["batch_per_node"] * FACADE["seq"], cfg.d_model,
        cfg.vocab_size, cfg.dt)]
    k1 = (k1_name,)
    case, out = facade_step(mesh, cfg)                  # warm-up
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with cs.counted() as counts:
        t0 = time.perf_counter()
        out = case.step_fn(*case.args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prof = cs.device_profile(lambda: case.step_fn(*case.args),
                             kernels=k1 + cs.FA_KERNELS + (cs.NCCL_KERNEL,))
    n_tok = case.n_tokens
    del case
    got = facade_whole(out)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    nccl_events, nccl_s = prof["kernels"][cs.NCCL_KERNEL]
    mine = {"launches": counts, "step_s": step_s, "peak_bytes": peak,
            "profiled": {k: prof["kernels"][k][0] for k in
                         k1 + cs.FA_KERNELS},
            "k1_device_s": prof["kernels"][k1_name][1],
            "nccl_kernels": nccl_events, "nccl_s": nccl_s,
            "device_busy_s": prof["device_busy_s"],
            "nccl_share_of_busy": (None if not prof["device_busy_s"] else
                                   nccl_s / prof["device_busy_s"]),
            "top_kernels_s": prof["top_kernels_s"]}
    every = [None] * world
    dist.all_gather_object(every, mine)
    res = None
    if rank == 0:
        plain, want = facade_step(None, cfg)
        torch.cuda.synchronize()
        with cs.counted() as one_counts:
            t0 = time.perf_counter()
            want = plain.step_fn(*plain.args)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
        del plain
        want = facade_whole(want)
        losses = want["losses"]
        margin = (losses[:, 0] - losses[:, 1]).abs()
        state_err = max(rel_err(a, b) for a, b in zip(
            got["leaves"], want["leaves"], strict=True))
        res = {"mesh": list(mesh.shape), "dtype": "float32", **FACADE,
               "tokens": n_tok, "losses_rel_err": rel_err(got["losses"],
                                                          losses),
               "state_rel_err": state_err,
               "cluster_id": got["cluster_id"].tolist(),
               "cluster_id_equal": bool(
                   torch.equal(got["cluster_id"], want["cluster_id"])
                   and torch.equal(got["info_cluster_id"],
                                   want["info_cluster_id"])),
               "selection_losses": losses.tolist(),
               "head_margin": margin.tolist(),
               "head_margin_over_tol": float(
                   margin.min() / (LOGIT_TOL * losses.abs().max())),
               "round_bytes": got["round_bytes"],
               "round_bytes_equal": got["round_bytes"] ==
               want["round_bytes"],
               "one_card_s": one_s, "one_card_launches": one_counts,
               "by_rank": every}
        nodes = FACADE["n_nodes"]
        n_fa = cfg.n_layers * nodes // mesh.shape[0]      # a pod's node
        res["ok"] = (res["losses_rel_err"] <= LOGIT_TOL
                     and state_err <= STATE_TOL and res["cluster_id_equal"]
                     and res["round_bytes_equal"]
                     and one_counts["head_losses"] == 1
                     and one_counts["flash_attention"] ==
                     cfg.n_layers * nodes
                     and all(r["launches"]["head_losses"] == 1
                             and r["profiled"][k1_name] == 1
                             and r["launches"]["flash_attention"] == n_fa
                             and sum(r["profiled"][k] for k in
                                     cs.FA_KERNELS) == n_fa
                             for r in every))
        print(json.dumps({"llama3.2-1b facade_pod": {
            k: v for k, v in res.items() if k != "by_rank"}}), flush=True)
        del want
    del got
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def shut_down(code: int):
    """Take the process group down and exit with ``code``; NCCL's teardown
    is given 60 s, then the process exits all the same."""
    t = threading.Thread(target=dist.destroy_process_group, daemon=True)
    t.start()
    t.join(timeout=60)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        import traceback
        traceback.print_exc()
        code = 1
    shut_down(code)
