"""grok-1-314b [hf:xai-org/grok-1] — MoE, 8 experts top-2.
64L d_model=6144 48H (GQA kv=8) expert d_ff=32768 vocab=131072."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="grok-1-314b-smoke", arch_type="moe", n_layers=2,
            d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=512,
            n_experts=4, experts_per_token=2, moe_d_ff=512,
            capacity_factor=8.0, dtype="float32")
    return ModelConfig(
        name="grok-1-314b", arch_type="moe", n_layers=64, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=32768, vocab_size=131072,
        n_experts=8, experts_per_token=2, moe_d_ff=32768)
