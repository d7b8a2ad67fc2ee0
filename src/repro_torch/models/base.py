"""Model configuration of the paper's CNNs (mirrors ``repro.models.base``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """Configs for the paper's own experimental models (GN-LeNet, ResNet8)."""

    name: str
    kind: str  # lenet | resnet8
    image_size: int = 32
    channels: int = 3
    n_classes: int = 10
    width: int = 32  # base conv width
    groups: int = 2  # group-norm groups
    head_blocks: int = 0  # resnet8: how many trailing blocks join the head
    dtype: str = "float32"

    @property
    def dt(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "CNNConfig":
        return dataclasses.replace(self, **kw)
