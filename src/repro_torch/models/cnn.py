"""The paper's experimental models: GN-LeNet (CIFAR-10/Imagenette runs) and
ResNet8 (Flickr-Mammals runs), both with GroupNorm as in Hsieh et al. [41].
Mirrors ``repro.models.cnn``.

FACADE head split (paper Sec. V-A "Models"):
  * GN-LeNet — head = final fully-connected layer ``fc``; the three conv
    blocks are the core.
  * ResNet8 — head = the last two basic blocks and ``fc``; the stem and
    the first block are the core.

Layouts at the boundary follow the reference: images and ResNet8's core
features are NHWC, LeNet's conv features are flattened in NHWC order, so
the ``fc`` weight's rows mean the same thing in both packages. Conv
kernels are OIHW (see ``interop``). Convolutions pad as the reference's
``"SAME"``: where the total padding is odd (a stride-2 3×3 conv on an even
size) the extra row and column go at the end.

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
RESNET8_HEAD_KEYS = ("block2", "block3", "fc")


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


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """(before, after) padding of ``"SAME"`` along one axis."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def node_conv(h, w, stride: int = 1):
    """``"SAME"`` convolution of node-batched NCHW activations
    ``[B, n*C, H, W]`` with node-stacked OIHW kernels ``[n, O, C, kh, kw]``:
    one conv with ``groups = n``."""
    (top, bottom), (left, right) = (
        _same_pad(size, k, stride)
        for size, k in zip(h.shape[-2:], w.shape[-2:]))
    wf = w.flatten(0, 1)
    if top == bottom and left == right:
        return F.conv2d(h, wf, stride=stride, padding=(top, left),
                        groups=w.shape[0])
    return F.conv2d(F.pad(h, (left, right, top, bottom)), wf, stride=stride,
                    groups=w.shape[0])


def _node_gn(cfg: CNNConfig, h, p: dict, n: int):
    return layers.group_norm_nchw(h, p["g"].flatten(), p["b"].flatten(),
                                  n * cfg.groups)


def _to_nchw(x):
    """[n, B, H, W, C] -> node-batched NCHW ``[B, n*C, H, W]``."""
    n, b, hh, ww, c = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(b, n * c, hh, ww)


def _to_nhwc(h, n: int):
    """Inverse of :func:`_to_nchw`."""
    b, nc, hh, ww = h.shape
    return h.reshape(b, n, nc // n, hh, ww).permute(1, 0, 3, 4, 2)


def _one(params: dict) -> dict:
    return {k: (_one(v) if isinstance(v, dict) else v.unsqueeze(0))
            for k, v in params.items()}


# ==========================================================================
# GN-LeNet
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


def lenet_node_features(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """x [n, B, H, W, C] -> [n, B, D], D the NHWC-flattened output of the
    three conv blocks."""
    n = x.shape[0]
    h = _to_nchw(x)
    for name in ("conv1", "conv2", "conv3"):
        p = params[name]
        h = _node_gn(cfg, node_conv(h, p["w"]), p["gn"], n)
        h = F.max_pool2d(F.relu(h), 2)
    # back to NHWC before the flatten, as the reference flattens
    return _to_nhwc(h, n).reshape(n, h.shape[0], -1)


def lenet_head(cfg: CNNConfig, head_params: dict, feats) -> torch.Tensor:
    """feats [..., B, D] -> logits [..., B, V]; node-stacked or not."""
    fc = head_params["fc"]
    return feats @ fc["w"] + fc["b"].unsqueeze(-2)


def lenet_features(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """x [B, H, W, C] -> flattened conv features [B, D]."""
    return lenet_node_features(cfg, _one(params), x.unsqueeze(0))[0]


# ==========================================================================
# ResNet8 (GN): stem + 3 basic blocks (16, 32, 64) + FC
def _init_block(generator: torch.Generator, cin: int, cout: int,
                dtype) -> dict:
    p = {"conv1": conv_init(generator, 3, 3, cin, cout, dtype),
         "gn1": _gn_params(cout, dtype),
         "conv2": conv_init(generator, 3, 3, cout, cout, dtype),
         "gn2": _gn_params(cout, dtype)}
    if cin != cout:
        p["proj"] = conv_init(generator, 1, 1, cin, cout, dtype)
    return p


def init_resnet8(cfg: CNNConfig, generator: torch.Generator) -> dict:
    """One model's parameters (CPU tensors) drawn from ``generator``: a
    stem of width ``cfg.width // 2`` (16 at width 32), then blocks
    16→16, 16→32 and 32→64, then ``fc``."""
    w, dt = cfg.width // 2, cfg.dt
    return {
        "stem": {"w": conv_init(generator, 3, 3, cfg.channels, w, dt),
                 "gn": _gn_params(w, dt)},
        "block1": _init_block(generator, w, w, dt),
        "block2": _init_block(generator, w, 2 * w, dt),
        "block3": _init_block(generator, 2 * w, 4 * w, dt),
        "fc": {"w": layers.dense_init(generator, 4 * w, cfg.n_classes, dt),
               "b": torch.zeros((cfg.n_classes,), dtype=dt)},
    }


def _block(cfg: CNNConfig, p: dict, h, n: int, stride: int):
    """One basic block on node-batched NCHW ``[B, n*C, H, W]``: two 3×3
    convs with GroupNorm, and the shortcut a 1×1 ``proj`` where the width
    changes, else the input (subsampled at ``stride``)."""
    y = F.relu(_node_gn(cfg, node_conv(h, p["conv1"], stride), p["gn1"], n))
    y = _node_gn(cfg, node_conv(y, p["conv2"]), p["gn2"], n)
    if "proj" in p:
        h = node_conv(h, p["proj"], stride)
    elif stride != 1:
        h = h[:, :, ::stride, ::stride]
    return F.relu(y + h)


def resnet8_node_features(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """The core, stem and block1: x [n, B, H, W, C] -> NHWC features
    ``[n, B, H, W, cfg.width // 2]``."""
    n = x.shape[0]
    p = params["stem"]
    h = F.relu(_node_gn(cfg, node_conv(_to_nchw(x), p["w"]), p["gn"], n))
    return _to_nhwc(_block(cfg, params["block1"], h, n, stride=1), n)


def resnet8_node_pooled(cfg: CNNConfig, head_params: dict,
                        feats) -> torch.Tensor:
    """The head up to ``fc``: block2 and block3 (stride 2 each), then the
    mean over H and W; feats [m, B, H, W, C] and head params with a
    leading ``[m]`` -> ``[m, B, 4 * C]``. ``fc`` is not read."""
    m = feats.shape[0]
    h = _block(cfg, head_params["block2"], _to_nchw(feats), m, stride=2)
    h = _block(cfg, head_params["block3"], h, m, stride=2)
    b, mc = h.shape[:2]
    return h.mean(dim=(2, 3)).reshape(b, m, mc // m).transpose(0, 1)


def resnet8_node_head(cfg: CNNConfig, head_params: dict,
                      feats) -> torch.Tensor:
    """feats [m, B, H, W, C] -> logits [m, B, V]."""
    return lenet_head(cfg, head_params,
                      resnet8_node_pooled(cfg, head_params, feats))


def resnet8_features(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """Core: stem + block1 (the head owns block2, block3, fc);
    x [B, H, W, C] -> [B, H, W, cfg.width // 2]."""
    return resnet8_node_features(cfg, _one(params), x.unsqueeze(0))[0]


def resnet8_head(cfg: CNNConfig, head_params: dict, feats) -> torch.Tensor:
    """feats [B, H, W, C] -> logits [B, V]."""
    return resnet8_node_head(cfg, _one(head_params), feats.unsqueeze(0))[0]


# ==========================================================================
# uniform API used by the FACADE trainer
def init_params(cfg: CNNConfig, generator: torch.Generator) -> dict:
    if cfg.kind == "lenet":
        return init_lenet(cfg, generator)
    if cfg.kind == "resnet8":
        return init_resnet8(cfg, generator)
    raise _unknown(cfg)


def head_keys(cfg: CNNConfig) -> tuple:
    if cfg.kind == "lenet":
        return LENET_HEAD_KEYS
    if cfg.kind == "resnet8":
        return RESNET8_HEAD_KEYS
    raise _unknown(cfg)


def node_features(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """Node-stacked core features of x [n, B, H, W, C] (the FACADE
    *core*'s output): LeNet ``[n, B, D]``, ResNet8 NHWC
    ``[n, B, H, W, C']``."""
    if cfg.kind == "lenet":
        return lenet_node_features(cfg, params, x)
    if cfg.kind == "resnet8":
        return resnet8_node_features(cfg, params, x)
    raise _unknown(cfg)


def node_head(cfg: CNNConfig, head_params: dict, feats) -> torch.Tensor:
    """Node-stacked head on :func:`node_features`' output -> logits
    ``[n, B, V]``."""
    if cfg.kind == "lenet":
        return lenet_head(cfg, head_params, feats)
    if cfg.kind == "resnet8":
        return resnet8_node_head(cfg, head_params, feats)
    raise _unknown(cfg)


def node_forward(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """x [n, B, H, W, C] -> logits [n, B, V]."""
    return node_head(cfg, params, node_features(cfg, params, x))


def node_losses(cfg: CNNConfig, params: dict, batch: dict) -> torch.Tensor:
    """Each node's mean CE on its own batch, ``[n]``."""
    logits = node_forward(cfg, params, batch["x"])
    return layers.nll(logits, batch["y"]).mean(dim=-1)


def forward(cfg: CNNConfig, params: dict, x) -> torch.Tensor:
    """x [B, H, W, C] -> logits [B, V]."""
    return node_forward(cfg, _one(params), x.unsqueeze(0))[0]


def loss_fn(cfg: CNNConfig, params: dict, batch: dict):
    logits = forward(cfg, params, batch["x"])
    loss = layers.softmax_xent(logits, batch["y"])
    acc = (logits.argmax(-1) == batch["y"]).float().mean()
    return loss, {"ce": loss, "acc": acc}


def _unknown(cfg: CNNConfig) -> NotImplementedError:
    return NotImplementedError(
        f"model kind {cfg.kind!r} is not a CNN of the paper; the port runs "
        "'lenet' and 'resnet8'")
