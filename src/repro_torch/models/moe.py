"""Mixture-of-experts FFN with capacity-based (GShard-style) dispatch
(mirrors ``repro.models.moe``), in plain PyTorch: the reference computes
it outside any Pallas kernel.

* Router math in fp32 (the router leaf stays fp32 in a bf16 model), top-k
  renormalised, and the Switch Transformer load-balance loss.
* Dispatch and combine go through a dense ``[E, C, D]`` buffer: each
  (token, k) pair's rank within its expert is an exclusive cumsum in
  flattened ``(token, k)`` order, a pair whose rank reaches the capacity
  ``C`` is dropped, and the expert FFN is one batched product over the
  experts, so compute is ``K * capacity_factor`` times the active-expert
  FLOPs, not ``E`` times.
* The reference splits the tokens into as many groups as its mesh's data
  axis has devices; without a mesh that is one group, which is what the
  port runs (``moe_forward`` has no group axis).
* The dispatch writes every pair to a row of its own with one index
  assignment (a kept pair to its ``(expert, rank)`` slot, a dropped pair
  to a spare row past the ``E * C`` slots, never read), and the combine
  gathers: no ``scatter_add``, no ``index_add`` and no two writes to one
  row, so the result does not depend on the order of writes on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from .base import ModelConfig


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> dict:
    e = cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    d = cfg.d_model

    def expert_stack(d_in, d_out):
        """[E, d_in, d_out], filled expert by expert (one fp32 draw of one
        expert at a time)."""
        out = torch.empty((e, d_in, d_out), dtype=cfg.dt,
                          device=generator.device)
        for i in range(e):
            out[i] = layers.dense_init(generator, d_in, d_out, cfg.dt)
        return out

    p = {
        "router": layers.dense_init(generator, d, e, torch.float32),
        "w_gate": expert_stack(d, ff),
        "w_up": expert_stack(d, ff),
        "w_down": expert_stack(ff, d),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = layers.init_swiglu(generator, d,
                                         cfg.n_shared_experts * ff, cfg.dt)
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int,
                 capacity_factor: float | None = None) -> int:
    cf = capacity_factor if capacity_factor is not None else \
        cfg.capacity_factor
    k = cfg.experts_per_token
    c = int(cf * n_tokens * k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8, floor 8


def _route(cfg: ModelConfig, p, xt):
    """xt [T,D] -> (probs [T,E] fp32, top-k weights renormalised [T,K],
    top-k experts [T,K], aux loss)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # aux load-balance loss (Switch): E * sum_e f_e * P_e
    sel = F.one_hot(topi, e).float().sum(1)                     # [T,E]
    aux = e * torch.sum((sel.mean(0) / k) * probs.mean(0))
    return probs, topw, topi, aux


def _experts(p, buf, dtype):
    """The expert FFN on ``buf`` [E,C,D], one batched product an op."""
    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    h = F.silu(g.float()).to(dtype) * u
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def moe_forward(cfg: ModelConfig, p, x,
                capacity_factor: float | None = None):
    """x [B,S,D] -> (out [B,S,D], aux loss fp32 scalar), one dispatch
    group of all B*S tokens."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(t, d)
    _, topw, topi, aux = _route(cfg, p, xt)

    # dispatch: (token, k) -> [E, C, D] at its rank within its expert
    cap = moe_capacity(cfg, t, capacity_factor)
    eid = topi.reshape(t * k)                                   # [TK]
    # each pair's rank within its expert: an exclusive cumsum over the
    # pairs, taken along the last dim of the one-hot's [E,TK] transpose (a
    # scan along the first dim of [TK,E] runs one thread a column on the
    # card: 2.3 ms a deepseek-moe-16b prefill layer on an H100)
    oh = F.one_hot(eid, e).t().contiguous()                     # [E,TK]
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(0)          # [TK]
    tok = xt.repeat_interleave(k, dim=0)                        # [TK,D]
    kept = pos < cap
    row = torch.where(kept, eid * cap + pos,
                      e * cap + torch.arange(t * k, device=x.device))
    buf = torch.zeros((e * cap + t * k, d), dtype=x.dtype, device=x.device)
    buf[row] = tok                                  # one write a row
    ob = _experts(p, buf[:e * cap].view(e, cap, d), x.dtype)    # [E,C,D]

    # combine: gather each pair's row, weight, zero the dropped, sum over k
    back = ob[eid, torch.clamp(pos, max=cap - 1)]               # [TK,D]
    w_flat = topw.reshape(t * k).to(x.dtype) * kept.to(x.dtype)
    out = (back * w_flat[:, None]).reshape(t, k, d).sum(1)
    if "shared" in p:
        out = out + layers.swiglu(p["shared"], xt)
    return out.reshape(b, s, d), aux


def moe_forward_dense(cfg: ModelConfig, p, x):
    """Oracle: every expert on every token, weighted by the sparse gates.
    ``E`` times the FLOPs; used only in tests, to hold the capacity
    dispatch (with a capacity that drops nothing the two agree to float
    tolerance)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    _, topw, topi, aux = _route(cfg, p, xt)
    gates = torch.zeros((t, cfg.n_experts), dtype=torch.float32,
                        device=x.device)
    gates[torch.arange(t, device=x.device)[:, None], topi] = topw
    g = torch.einsum("td,edf->etf", xt, p["w_gate"])
    u = torch.einsum("td,edf->etf", xt, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    ye = torch.einsum("etf,efd->etd", h, p["w_down"])            # [E,T,D]
    out = torch.einsum("te,etd->td", gates.to(x.dtype), ye)
    if "shared" in p:
        out = out + layers.swiglu(p["shared"], xt)
    return out.reshape(b, s, d), aux
