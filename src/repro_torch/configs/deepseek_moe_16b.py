"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE, 2 shared + 64
routed top-6. 28L d_model=2048 16H d_ff(expert)=1408 vocab=102400."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="deepseek-moe-16b-smoke", arch_type="moe", n_layers=2,
            d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=512,
            n_experts=4, n_shared_experts=1, experts_per_token=2,
            moe_d_ff=128, capacity_factor=8.0, dtype="float32")
    return ModelConfig(
        name="deepseek-moe-16b", arch_type="moe", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400,
        n_experts=64, n_shared_experts=2, experts_per_token=6, moe_d_ff=1408)
