"""Uniform model API over the three backbones (decoder LM, encoder-decoder,
CNN), mirroring ``repro.models.api``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves

from . import cnn, transformer, whisper
from .base import CNNConfig, ModelConfig


def is_encdec(cfg) -> bool:
    return isinstance(cfg, ModelConfig) and cfg.encoder_layers > 0


def is_cnn(cfg) -> bool:
    return isinstance(cfg, CNNConfig)


def init_params(cfg, generator: torch.Generator) -> dict:
    """Parameters of ``cfg``'s model, drawn from ``generator`` (on its
    device for the language models)."""
    if is_cnn(cfg):
        return cnn.init_params(cfg, generator)
    if is_encdec(cfg):
        return whisper.init_params(cfg, generator)
    return transformer.init_params(cfg, generator)


def loss_fn(cfg, params, batch, remat: bool = False):
    """-> (scalar loss, metrics dict), for every backbone the port runs.
    ``remat`` recomputes each transformer layer in the backward pass (the
    same loss and gradients, less memory); the CNN ignores it."""
    if is_cnn(cfg):
        return cnn.loss_fn(cfg, params, batch)
    if is_encdec(cfg):
        return whisper.loss_fn(cfg, params, batch, remat=remat)
    return transformer.loss_fn(cfg, params, batch, remat=remat)


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))
