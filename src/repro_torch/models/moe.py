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
* Grouped dispatch, as the reference's: the tokens are split into ``G``
  groups (``hooks.data_axis_size()``, the data axes' size of a DTensor
  input's mesh while the sharding hooks are on; 1 otherwise, and 1 where
  it does not divide the token count) and each group has its own capacity
  (``moe_capacity`` of its ``T / G`` tokens) and ranks. With one group and
  plain tensors the dispatch is the single-group code below, bit for bit.
  On DTensors the groups lie on the data axes: routing, dispatch and
  combine run on each rank's local groups (``localmap.on_shards``: the
  index assignment has no DTensor sharding rule), the expert products on
  DTensors (the expert stacks sharded as ``launch.shardings`` lays them
  out), and the router loss sums its per-group counts over the ranks.
* The dispatch writes every pair to a row of its own with one index
  assignment (a kept pair to its ``(expert, rank)`` slot, a dropped pair
  to a spare row past the ``E * C`` slots, never read), and the combine
  gathers: no ``scatter_add``, no ``index_add`` and no two writes to one
  row, so the result does not depend on the order of writes on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import localmap

from . import hooks, layers
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


def _experts(p, buf, dtype, grouped: bool = False):
    """The expert FFN on ``buf`` [E,C,D] (``grouped``: [G,E,C,D]), one
    batched product an op."""
    g_ = "g" if grouped else ""
    if localmap.is_dtensor(buf):
        buf = buf.contiguous()      # einsum views each rank's shard
    g = torch.einsum(f"{g_}ecd,edf->{g_}ecf", buf, p["w_gate"])
    u = torch.einsum(f"{g_}ecd,edf->{g_}ecf", buf, p["w_up"])
    h = F.silu(g.float()).to(dtype) * u
    if localmap.is_dtensor(h):
        h = h.contiguous()
    return torch.einsum(f"{g_}ecf,efd->{g_}ecd", h, p["w_down"])


def _dispatch(cfg: ModelConfig, xt, topi, cap: int):
    """One group's dispatch: xt [T,D], topi [T,K] -> (buf [E,C,D], eid
    [TK], pos [TK], kept [TK])."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
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
                      e * cap + torch.arange(t * k, device=xt.device))
    buf = torch.zeros((e * cap + t * k, d), dtype=xt.dtype,
                      device=xt.device)
    buf[row] = tok                                  # one write a row
    return buf[:e * cap].view(e, cap, d), eid, pos, kept


def _combine(ob, eid, pos, kept, topw, k: int):
    """One group's combine: gather each pair's row of ob [E,C,D], weight,
    zero the dropped, sum over k -> [T,D]."""
    cap, d = ob.shape[1], ob.shape[2]
    back = ob[eid, torch.clamp(pos, max=cap - 1)]               # [TK,D]
    w_flat = topw.reshape(-1).to(ob.dtype) * kept.to(ob.dtype)
    return (back * w_flat[:, None]).reshape(-1, k, d).sum(1)


def moe_forward(cfg: ModelConfig, p, x,
                capacity_factor: float | None = None,
                groups: int | None = None):
    """x [B,S,D] -> (out [B,S,D], aux loss fp32 scalar). ``groups``: the
    dispatch's group count (default the sharding hooks' data-axis size,
    module docstring)."""
    b, s, d = x.shape
    t = b * s
    g_n = hooks.data_axis_size(x) if groups is None else groups
    if t % g_n:
        g_n = 1
    if g_n > 1 or localmap.is_dtensor(x):
        return _grouped(cfg, p, x, g_n, capacity_factor)
    k = cfg.experts_per_token
    xt = x.reshape(t, d)
    _, topw, topi, aux = _route(cfg, p, xt)
    cap = moe_capacity(cfg, t, capacity_factor)
    buf, eid, pos, kept = _dispatch(cfg, xt, topi, cap)
    ob = _experts(p, buf, x.dtype)                              # [E,C,D]
    out = _combine(ob, eid, pos, kept, topw, k)
    if "shared" in p:
        out = out + layers.swiglu(p["shared"], xt)
    return out.reshape(b, s, d), aux


def _grouped(cfg: ModelConfig, p, x, g_n: int, capacity_factor):
    """The reference's grouped dispatch over ``g_n`` groups of ``T/g_n``
    tokens; on DTensors each rank runs its local groups."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    tg = t // g_n
    cap = moe_capacity(cfg, tg, capacity_factor)
    xt = hooks.shard_batch(x.reshape(g_n, tg, d))               # [G,Tg,D]

    def route_and_dispatch(xg, router):
        bufs, eids, poss, keeps, topws = [], [], [], [], []
        sel = torch.zeros((e,), dtype=torch.float32, device=xg.device)
        psum = torch.zeros((e,), dtype=torch.float32, device=xg.device)
        for xi in xg.unbind(0):
            probs, topw, topi, _ = _route(cfg, {"router": router}, xi)
            sel = sel + F.one_hot(topi, e).float().sum((0, 1))
            psum = psum + probs.sum(0)
            buf, eid, pos, kept = _dispatch(cfg, xi, topi, cap)
            for acc, v in ((bufs, buf), (eids, eid), (poss, pos),
                           (keeps, kept), (topws, topw)):
                acc.append(v)
        return (torch.stack(bufs), torch.stack(eids), torch.stack(poss),
                torch.stack(keeps), torch.stack(topws), sel, psum)

    def combine(ob, eid, pos, kept, topw):
        return torch.stack([_combine(*g, k) for g in zip(
            ob.unbind(0), eid.unbind(0), pos.unbind(0), kept.unbind(0),
            topw.unbind(0))])

    if localmap.is_dtensor(xt):
        lm = localmap
        xt = lm.settle(xt, (0,), "moe tokens")
        grp = tuple(xt.placements)
        sums = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                     for pl in grp)
        router = lm.like(p["router"], xt, {})
        buf, eid, pos, kept, topw, sel, psum = lm.on_shards(
            route_and_dispatch, (xt, router), (grp,) * 5 + (sums,) * 2)
        ob = lm.settle(_experts(p, buf, x.dtype, grouped=True), (0,),
                       "moe experts' output")
        out = lm.on_shards(combine, (ob, eid, pos, kept, topw), grp)
    else:
        buf, eid, pos, kept, topw, sel, psum = route_and_dispatch(
            xt, p["router"])
        out = combine(_experts(p, buf, x.dtype, grouped=True), eid, pos,
                      kept, topw)
    aux = e * torch.sum((sel / t / k) * (psum / t))
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
