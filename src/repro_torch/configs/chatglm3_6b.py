"""ChatGLM3-6B [dense; arXiv:2406.12793].

28 layers, GQA 32 heads / 2 kv, 2d-RoPE (rotary on half the head dims),
SwiGLU d_ff 13696, vocab 65024.
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="chatglm3-6b", family="dense",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=65024,
        kv_pad_to=16,
        rope_fraction=0.5, mlp_type="swiglu", tie_embeddings=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="chatglm3-reduced", family="dense",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        rope_fraction=0.5, mlp_type="swiglu", tie_embeddings=False,
        attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
