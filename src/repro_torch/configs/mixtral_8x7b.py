"""Mixtral 8x7B [moe; arXiv:2401.04088].

32 layers, GQA 32 heads / 8 kv, sliding-window 4096 attention, MoE on
every layer: 8 experts top-2, d_ff 14336, vocab 32000.
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=32000,
        kv_pad_to=16,
        num_experts=8, experts_per_token=2, sliding_window=4096,
        mlp_type="swiglu", tie_embeddings=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="mixtral-reduced", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=128,
        num_experts=4, experts_per_token=2, sliding_window=8,
        mlp_type="swiglu", tie_embeddings=False, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
