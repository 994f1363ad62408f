"""StarCoder2-15B [dense; arXiv:2402.19173].

40 layers, GQA 48 heads / 4 kv (head_dim 128), non-gated GELU MLP
d_ff 24576, RoPE, vocab 49152.  (HF config also uses a 4k sliding window;
the assigned spec says plain GQA+RoPE, so full attention here.)
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
        d_ff=24576, vocab_size=49152,
        kv_pad_to=16,
        mlp_type="gelu", tie_embeddings=True,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="starcoder2-reduced", family="dense",
        num_layers=4, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=192, vocab_size=128,
        mlp_type="gelu", tie_embeddings=True, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
