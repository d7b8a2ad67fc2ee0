"""rwkv6-1.6b "Finch" [arXiv:2404.05892] — attention-free, data-dependent
decay. 24L d_model=2048 d_ff=7168 vocab=65536. Decode state is O(1), so all
decode shapes (incl. long_500k) run natively."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="rwkv6-1.6b-smoke", arch_type="ssm", n_layers=2,
            d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=512,
            attention="none", rwkv=True, dtype="float32")
    return ModelConfig(
        name="rwkv6-1.6b", arch_type="ssm", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=7168, vocab_size=65536,
        attention="none", rwkv=True)
