"""stablelm-12b [hf:stabilityai/stablelm-2-12b family] — dense GQA.
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="stablelm-12b-smoke", arch_type="dense", n_layers=2,
            d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=512,
            dtype="float32")
    return ModelConfig(
        name="stablelm-12b", arch_type="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=13824, vocab_size=100352)
