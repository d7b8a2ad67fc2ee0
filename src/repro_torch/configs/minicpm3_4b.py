"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — dense, MLA attention.
62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="minicpm3-4b-smoke", arch_type="dense", n_layers=2,
            d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=512,
            attention="mla", q_lora_rank=96, kv_lora_rank=64, qk_rope_dim=16,
            qk_nope_dim=32, v_head_dim=32, dtype="float32")
    return ModelConfig(
        name="minicpm3-4b", arch_type="dense", n_layers=62, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=6400, vocab_size=73448,
        attention="mla", q_lora_rank=768, kv_lora_rank=256, qk_rope_dim=32,
        qk_nope_dim=64, v_head_dim=64)
