"""hymba-1.5b [arXiv:2411.13676] — hybrid: parallel attention + mamba heads.
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Attention is natively sliding-window (global attn in a few layers in the
paper; we use SWA uniformly), which is what makes long_500k decode viable."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="hymba-1.5b-smoke", arch_type="hybrid", n_layers=2,
            d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512,
            ssm_state=8, ssm_expand=1, sliding_window=64, dtype="float32")
    return ModelConfig(
        name="hymba-1.5b", arch_type="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001,
        ssm_state=16, ssm_expand=1, sliding_window=1024)
