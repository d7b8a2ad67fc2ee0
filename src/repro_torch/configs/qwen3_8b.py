"""qwen3-8b [hf:Qwen/Qwen3-8B] — dense GQA with qk-norm, head_dim=128.
36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="qwen3-8b-smoke", arch_type="dense", n_layers=2,
            d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=512,
            qk_norm=True, head_dim=32, dtype="float32")
    return ModelConfig(
        name="qwen3-8b", arch_type="dense", n_layers=36, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=12288, vocab_size=151936,
        qk_norm=True, head_dim=128, rope_theta=1e6)
