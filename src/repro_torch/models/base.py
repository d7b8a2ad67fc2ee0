"""Model configuration dataclasses and the architecture registry (mirrors
``repro.models.base``).

Every language-model architecture is described by one ``ModelConfig``;
``transformer.py`` (and ``whisper.py`` for the encoder-decoder) interprets
it. ``dt`` gives the ``torch.dtype`` of the parameters. The registry is
filled by ``repro_torch.configs`` with the reference's ten archs.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig`` fields that the ported families
    (dense GQA, MLA, MoE, RWKV6, hybrid, VLM, encoder-decoder) read; the
    reference's ``head_keys`` and ``scan_unroll`` are left out (every
    config keeps their defaults, and nothing of the port reads them)."""

    name: str
    arch_type: str  # dense | moe | hybrid | ssm | vlm | audio | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention variant ------------------------------------------------
    attention: str = "gqa"  # gqa | mla | none (rwkv)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention; >0 enables SWA variant

    # --- MLA (multi-head latent attention, MiniCPM3/DeepSeek-V2 style) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert ffn width (fine-grained MoE)
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # --- hybrid (hymba: parallel attention + mamba heads) -------------------
    ssm_state: int = 0
    ssm_expand: int = 1  # d_inner = ssm_expand * d_model
    ssm_conv: int = 4

    # --- rwkv6 ---------------------------------------------------------------
    rwkv: bool = False

    # --- encoder-decoder (whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0  # number of (stubbed) audio frames
    cross_attention: bool = False
    max_decoder_len: int = 0  # whisper caps ctx at 448

    # --- vlm -----------------------------------------------------------------
    n_image_tokens: int = 0  # stubbed patch embeddings prepended to text

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # ---------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def dt(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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


# --------------------------------------------------------------------------
# registry: populated by repro_torch.configs
_REGISTRY: dict = {}


def register(arch_id: str, fn) -> None:
    _REGISTRY[arch_id] = fn


def get_config(arch_id: str, smoke: bool = False):
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id](smoke=smoke)


def list_archs():
    return sorted(_REGISTRY)
