"""InternVL2-26B backbone [vlm; arXiv:2404.16821].

The InternLM2-20B language backbone: 48 layers, GQA 48 heads / 8 kv,
d_model 6144, d_ff 16384, vocab 92553.  The InternViT vision frontend is a
STUB per the brief: input_specs provides 1024 precomputed patch embeddings
prepended to the token sequence.
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="internvl2-26b", family="vlm",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92553, num_patches=1024,
        kv_pad_to=16,
        mlp_type="swiglu", tie_embeddings=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="internvl2-reduced", family="vlm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128, num_patches=4,
        mlp_type="swiglu", tie_embeddings=False, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
