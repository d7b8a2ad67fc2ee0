"""whisper-tiny [arXiv:2212.04356] — enc-dec audio backbone.
4L(enc)+4L(dec) d_model=384 6H d_ff=1536 vocab=51865; the conv/mel frontend
is a stub, as in the reference (the caller supplies 1500 frame embeddings).
Decoder context cap 448, as the family's; decode clamps its position
embedding there."""
from repro_torch.models.base import ModelConfig


def make(smoke: bool = False) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="whisper-tiny-smoke", arch_type="audio", n_layers=2,
            d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
            encoder_layers=2, encoder_seq=32, cross_attention=True,
            max_decoder_len=64, tie_embeddings=True, dtype="float32")
    return ModelConfig(
        name="whisper-tiny", arch_type="audio", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51865,
        encoder_layers=4, encoder_seq=1500, cross_attention=True,
        max_decoder_len=448, tie_embeddings=True)
