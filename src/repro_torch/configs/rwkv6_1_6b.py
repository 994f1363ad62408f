"""RWKV-6 'Finch' 1.6B [ssm; arXiv:2404.05892].

24 attention-free layers with data-dependent-decay time mixing (32 heads
of dim 64) and squared-ReLU channel mixing d_ff 7168, d_model 2048,
vocab 65536.
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="rwkv6-1.6b", family="ssm", attention="none", ssm_type="rwkv6",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        rwkv_head_dim=64, d_ff=7168, vocab_size=65536,
        mlp_type="relu_sq", tie_embeddings=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="rwkv6-reduced", family="ssm", attention="none", ssm_type="rwkv6",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        rwkv_head_dim=16, d_ff=224, vocab_size=128,
        mlp_type="relu_sq", tie_embeddings=False, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
