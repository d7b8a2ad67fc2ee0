"""llava-next-34b [hf:llava-hf/llava-v1.6 family] — VLM language decoder.
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, anyres tiling.

The ViT/SigLIP tower + projector is a stub, as in the reference: the
caller supplies anyres patch embeddings [B, 2880, d_model] (5 tiles x 576
patches), which the decoder consumes as prefix positions."""
from repro_torch.models.base import ModelConfig

ANYRES_TILES = 5
PATCHES_PER_TILE = 576


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="llava-next-34b-smoke", arch_type="vlm", n_layers=2,
            d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=512,
            n_image_tokens=16, dtype="float32")
    return ModelConfig(
        name="llava-next-34b", arch_type="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=20480, vocab_size=64000,
        n_image_tokens=ANYRES_TILES * PATCHES_PER_TILE)
