"""One-op stand-ins for the port's sequential loops, for tracing on fake
tensors.

The plain versions of two recurrences are Python loops over the sequence:
``kernels/rwkv6/ref.wkv_scan`` (RWKV's wkv, whose kernel is K3) and the
selective scan of ``models/ssm.ssm_scan`` (hymba's mamba branch). Traced
on ``FakeTensorMode`` tensors, as the dry run (``launch/dryrun.py``)
traces a step, such a loop dispatches a few ops a step, and at S 32,768
over tens of layers that takes hours. So each loop, given fake tensors,
calls its stand-in instead: one op ``repro_torch::<name>`` whose real
implementation is the loop itself (the same values on real tensors),
whose fake implementation gives the outputs' shapes, and whose backward
is one op ``repro_torch::<name>_backward`` (really: the loop recomputed
and differentiated by autograd).

What a trace counts through a stand-in: FLOPs as
``torch.utils.flop_counter.FlopCounterMode`` counts the loop it stands
for (its matmuls; elementwise ops count 0), from the formula registered
with the op; bytes once for its inputs and outputs, as one fused kernel
moves them (the loop's per-step state traffic is what K3 keeps on chip).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

_NS = "repro_torch"


def is_fake(x) -> bool:
    """True for a tensor of ``torch._subclasses.fake_tensor.FakeTensorMode``
    (shapes and dtypes, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def define(name: str, args: tuple, n_out: int, loop, fake,
           fwd_flops=None, bwd_flops=None):
    """Register ``repro_torch::<name>(*args) -> n_out tensors`` and its
    backward, and return the op. ``loop(*tensors)`` is the plain loop (a
    tuple of ``n_out`` tensors), ``fake(*tensors)`` the outputs' empty
    tensors; ``fwd_flops(*shapes)`` and ``bwd_flops(*shapes)`` (shapes of
    ``args``) what ``FlopCounterMode`` counts for the loop and for its
    backward (None: 0)."""
    sig = ", ".join(f"Tensor {a}" for a in args)
    grads = ", ".join(f"Tensor g{i}" for i in range(n_out))
    outs = ", ".join(["Tensor"] * n_out)
    ins = ", ".join(["Tensor"] * len(args))
    torch.library.define(f"{_NS}::{name}", f"({sig}) -> ({outs})")
    torch.library.define(f"{_NS}::{name}_backward",
                         f"({sig}, {grads}) -> ({ins})")

    def real(*xs):
        return tuple(o.clone() for o in loop(*xs))

    def real_backward(*xs):
        inputs = [x.detach().requires_grad_() for x in xs[:len(args)]]
        with torch.enable_grad():
            outs = loop(*inputs)
            return tuple(torch.autograd.grad(
                outs, inputs, xs[len(args):], allow_unused=True,
                materialize_grads=True))

    def fake_backward(*xs):
        return tuple(torch.empty_like(x) for x in xs[:len(args)])

    torch.library.impl(f"{_NS}::{name}", "CompositeExplicitAutograd",
                       real)
    torch.library.impl(f"{_NS}::{name}_backward",
                       "CompositeExplicitAutograd", real_backward)
    torch.library.register_fake(f"{_NS}::{name}", fake)
    torch.library.register_fake(f"{_NS}::{name}_backward", fake_backward)
    op = getattr(torch.ops, _NS).__getattr__(name)
    op_backward = getattr(torch.ops, _NS).__getattr__(f"{name}_backward")

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output)

    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        inputs, outputs = saved[:len(args)], saved[len(args):]
        grads = [torch.zeros_like(o) if g is None else g
                 for g, o in zip(grads, outputs)]
        return tuple(op_backward(*inputs, *grads))

    torch.library.register_autograd(f"{_NS}::{name}", backward,
                                    setup_context=setup_context)
    for target, formula in ((op, fwd_flops), (op_backward, bwd_flops)):
        if formula is not None:
            register_flop_formula(target)(
                lambda *shapes, out_shape=None, _f=formula, **kw:
                _f(*shapes[:len(args)]))
    return op
