"""Gemma-3 12B [dense; hf:google/gemma-3 family].

48 layers, 5 local (sliding-window 1024) : 1 global pattern, d_model 3840,
16 heads / 8 kv with head_dim 256, GeGLU d_ff 15360, vocab 262144.
RoPE theta 1e6 (single theta for both layer kinds — adaptation noted).
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="gemma3-12b", family="dense",
        num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
        d_ff=15360, vocab_size=262144,
        kv_pad_to=16,
        global_every=6, global_offset=5, sliding_window=1024,
        mlp_type="geglu", tie_embeddings=True, rope_theta=1e6,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="gemma3-reduced", family="dense",
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        global_every=6, global_offset=5, sliding_window=8,
        mlp_type="geglu", tie_embeddings=True, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
