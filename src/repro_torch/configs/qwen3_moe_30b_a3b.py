"""Qwen3-MoE 30B-A3B [moe; hf:Qwen/Qwen3-30B-A3B].

48 layers, GQA 32 heads / 4 kv (head_dim 128, QK-norm), MoE on every
layer: 128 experts, top-8 (renormalized), expert d_ff 768, vocab 151936.
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
        d_ff=768, vocab_size=151936,
        kv_pad_to=16,
        num_experts=128, experts_per_token=8, norm_topk=True, qk_norm=True,
        mlp_type="swiglu", tie_embeddings=False, rope_theta=1e6,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="qwen3-moe-reduced", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=128,
        num_experts=8, experts_per_token=2, norm_topk=True, qk_norm=True,
        mlp_type="swiglu", tie_embeddings=False, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
