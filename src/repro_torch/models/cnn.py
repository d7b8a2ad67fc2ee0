"""GN-LeNet, the paper's CIFAR-10/Imagenette model, with GroupNorm as in
Hsieh et al. [41]. Mirrors ``repro.models.cnn`` for LeNet.

FACADE head split (paper Sec. V-A "Models"): the head of GN-LeNet is its
final fully-connected layer ``fc``; the three conv blocks are the core.

Layouts at the boundary follow the reference: images are NHWC and the conv
features are flattened in NHWC order, so the ``fc`` weight's rows mean the
same thing in both packages. Conv kernels are OIHW (see ``interop``).

The ``node_*`` functions take node-stacked parameters (a leading ``[n]``
axis on every leaf) and run all nodes in one pass: the nodes' channels
sit side by side and each conv is one grouped convolution with
``groups = n``, so node ``i`` only ever sees its own weights. The
single-model functions are those with ``n = 1``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers
from .base import CNNConfig

LENET_HEAD_KEYS = ("fc",)


def conv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
              cout: int, dtype) -> torch.Tensor:
    """He-normal conv kernel, OIHW."""
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=generator,
                    dtype=torch.float32) * math.sqrt(2.0 / fan_in)
    return w.to(dtype)


def _gn_params(c: int, dtype) -> dict:
    return {"g": torch.ones((c,), dtype=dtype),
            "b": torch.zeros((c,), dtype=dtype)}


def init_lenet(cfg: CNNConfig, generator: torch.Generator) -> dict:
    """One model's parameters (CPU tensors) drawn from ``generator``."""
    w, dt = cfg.width, cfg.dt
    feat = (cfg.image_size // 8) ** 2 * w
    return {
        "conv1": {"w": conv_init(generator, 3, 3, cfg.channels, w, dt),
                  "gn": _gn_params(w, dt)},
        "conv2": {"w": conv_init(generator, 3, 3, w, w, dt),
                  "gn": _gn_params(w, dt)},
        "conv3": {"w": conv_init(generator, 3, 3, w, w, dt),
                  "gn": _gn_params(w, dt)},
        "fc": {"w": layers.dense_init(generator, feat, cfg.n_classes, dt),
               "b": torch.zeros((cfg.n_classes,), dtype=dt)},
    }


def node_features(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """Node-stacked core features: x [n, B, H, W, C] -> [n, B, D], D the
    NHWC-flattened output of the three conv blocks (the FACADE *core*)."""
    n, b, hh, ww, c = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(b, n * c, hh, ww)
    for name in ("conv1", "conv2", "conv3"):
        p = params[name]
        # 3x3 stride-1 "SAME" is symmetric padding 1
        h = F.conv2d(h, p["w"].flatten(0, 1), padding=1, groups=n)
        h = layers.group_norm_nchw(h, p["gn"]["g"].flatten(),
                                   p["gn"]["b"].flatten(), n * cfg.groups)
        h = F.max_pool2d(F.relu(h), 2)
    _, nc, hh, ww = h.shape
    # back to NHWC before the flatten, as the reference flattens
    h = h.reshape(b, n, nc // n, hh, ww).permute(1, 0, 3, 4, 2)
    return h.reshape(n, b, -1)


def lenet_head(cfg: CNNConfig, head_params: dict, feats) -> torch.Tensor:
    """feats [..., B, D] -> logits [..., B, V]; node-stacked or not."""
    fc = head_params["fc"]
    return feats @ fc["w"] + fc["b"].unsqueeze(-2)


def node_forward(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """x [n, B, H, W, C] -> logits [n, B, V]."""
    return lenet_head(cfg, params, node_features(cfg, params, x))


def node_losses(cfg: CNNConfig, params: dict, batch: dict) -> torch.Tensor:
    """Each node's mean CE on its own batch, ``[n]``."""
    logits = node_forward(cfg, params, batch["x"])
    return layers.nll(logits, batch["y"]).mean(dim=-1)


def _one(params: dict) -> dict:
    return {k: (_one(v) if isinstance(v, dict) else v.unsqueeze(0))
            for k, v in params.items()}


def lenet_features(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """x [B, H, W, C] -> flattened conv features [B, D]."""
    return node_features(cfg, _one(params), x.unsqueeze(0))[0]


def forward(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    return lenet_head(cfg, params, lenet_features(cfg, params, x))


def loss_fn(cfg: CNNConfig, params: dict, batch: dict):
    logits = forward(cfg, params, batch["x"])
    loss = layers.softmax_xent(logits, batch["y"])
    acc = (logits.argmax(-1) == batch["y"]).float().mean()
    return loss, {"ce": loss, "acc": acc}


def init_params(cfg: CNNConfig, generator: torch.Generator) -> dict:
    _lenet_only(cfg)
    return init_lenet(cfg, generator)


def head_keys(cfg: CNNConfig) -> tuple:
    _lenet_only(cfg)
    return LENET_HEAD_KEYS


def _lenet_only(cfg: CNNConfig) -> None:
    if cfg.kind != "lenet":
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet; the port runs "
            "GN-LeNet")
