"""ResNet8 under FACADE on the card against the CPU, and the modules of the
launcher slice (the optimizers, the checkpoint files, ``launch.train``) on
the card.

Needs an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason. This file imports no JAX. Tolerances: selection losses 1e-5 and
parameters after the round 1e-4 of each leaf's scale (fp32 on both, TF32
off; cuDNN's grouped convolutions and the kernel sum in other orders);
cluster ids and bytes exact.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.facade_paper import resnet8
from repro_torch.core import facade
from repro_torch.core.bindings import make_binding
from repro_torch.core.state import init_facade_state
from repro_torch.device import no_tf32
from repro_torch.kernels.head_select import head_losses
from repro_torch.launch import train
from repro_torch.tree import tree_leaves, tree_map
from torch_caps import cuda_device, requires_cuda  # noqa: F401

N, K, DEG, H, B = 6, 2, 2, 2, 4


def _round(device):
    cfg = resnet8(smoke=True)
    binding = make_binding(cfg)
    state = init_facade_state(binding, N, K, head_jitter=0.05, device=device,
                              generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batches = {"x": torch.randn((N, H, B, cfg.image_size, cfg.image_size,
                                 cfg.channels), generator=g).to(device),
               "y": torch.randint(0, cfg.n_classes, (N, H, B),
                                  generator=g).to(device)}
    perms = torch.stack([torch.randperm(N, generator=g)
                         for _ in range(DEG // 2)]).to(device)
    with no_tf32():
        return facade.facade_round(
            facade.FacadeConfig(n_nodes=N, k=K, degree=DEG, lr=0.05),
            binding, state, batches, perms)


@requires_cuda
def test_facade_round_on_the_card_matches_the_cpu(cuda_device):
    head_losses.launches = 0
    got, ginfo = _round(cuda_device)
    assert head_losses.launches == 1               # step 2c ran K1 once
    want, winfo = _round("cpu")
    torch.testing.assert_close(ginfo["selection_losses"].cpu(),
                               winfo["selection_losses"], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got.cluster_id.cpu(), want.cluster_id)
    assert ginfo["round_bytes"] == winfo["round_bytes"]
    for a, b in zip(tree_leaves(got.cores) + tree_leaves(got.heads),
                    tree_leaves(want.cores) + tree_leaves(want.heads)):
        assert a.device.type == "cuda"
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale


@requires_cuda
def test_launcher_modules_on_the_card(cuda_device, tmp_path):
    """An AdamW step over card tensors stays on the card, a card tree
    checkpoints to CPU tensors bit for bit, and ``train.main`` in lm mode
    runs on the card."""
    params = {"w": torch.randn((4, 3), device=cuda_device),
              "e": torch.randn((2, 5), device=cuda_device).to(torch.bfloat16)}
    opt = optim.master_weights(optim.adamw(optim.cosine_warmup(0.1, 1, 4)))
    state = opt.init(params)
    with torch.no_grad():
        ups, state = opt.update(tree_map(torch.ones_like, params), state,
                                params)
    new = optim.apply_updates(params, ups)
    assert all(t.device.type == "cuda" for t in tree_leaves(new))
    path = str(tmp_path / "ck.npz")
    ckpt_io.save(path, {"params": new, "opt": state})
    back, _ = ckpt_io.load(path)
    for a, b in zip(tree_leaves(back["params"]), tree_leaves(new)):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu())
    out = train.main(["--mode", "lm", "--arch", "rwkv6-1.6b", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--ckpt",
                      str(tmp_path / "lm.npz")])
    assert len(out["losses"]) == 2
    assert all(t.device.type == "cuda" for t in tree_leaves(out["params"]))
