"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B] — small dense llama3, tied embeds.
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="llama3.2-1b-smoke", arch_type="dense", n_layers=2,
            d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=512,
            tie_embeddings=True, dtype="float32")
    return ModelConfig(
        name="llama3.2-1b", arch_type="dense", n_layers=16, d_model=2048,
        n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=128256,
        tie_embeddings=True, rope_theta=500000.0)
