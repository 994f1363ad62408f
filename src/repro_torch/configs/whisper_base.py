"""Whisper-base [audio; arXiv:2212.04356].

Encoder-decoder, 6+6 layers, d_model 512, 8 heads, GELU d_ff 2048, vocab
51865.  The conv frontend is a STUB: input_specs provides 1500 precomputed
log-mel frame embeddings (post-conv).  Adaptation: RoPE replaces whisper's
learned/sinusoidal positions (noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="whisper-base", family="audio",
        num_layers=6, encoder_layers=6, encoder_seq=1500,
        d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=51865,
        mlp_type="gelu", tie_embeddings=True,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="whisper-reduced", family="audio",
        num_layers=2, encoder_layers=2, encoder_seq=12,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128,
        mlp_type="gelu", tie_embeddings=True, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
