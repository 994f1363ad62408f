"""Jamba-v0.1 52B [hybrid; arXiv:2403.19887].

32 layers, attention:Mamba 1:7 interleave (attention at position 4 of each
8-layer period, as in the paper), MoE (16 experts, top-2) on every other
layer.  d_model 4096, 32 heads / 8 kv, d_ff 14336, vocab 65536.
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536,
        kv_pad_to=16,
        attn_every=8, attn_offset=4, ssm_type="mamba",
        d_state=16, d_conv=4, expand=2, ssm_chunk=256,
        num_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
        mlp_type="swiglu", tie_embeddings=False, rope_theta=1e4,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="jamba-reduced", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=128,
        attn_every=8, attn_offset=4, ssm_type="mamba",
        d_state=4, d_conv=4, expand=2, ssm_chunk=8,
        num_experts=4, experts_per_token=2, moe_every=2, moe_offset=1,
        mlp_type="swiglu", tie_embeddings=False, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
