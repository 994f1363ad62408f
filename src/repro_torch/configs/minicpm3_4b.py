"""MiniCPM3-4B [dense, MLA; hf:openbmb/MiniCPM3-4B].

62 layers, multi-head latent attention (q_lora 768, kv_lora 256, nope 64 +
rope 32 per head, v 64), 40 heads, d_model 2560, d_ff 6400, vocab 73448.
"""
from repro_torch.models.config import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        name="minicpm3-4b", family="dense", attention="mla",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=6400, vocab_size=73448,
        q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
        v_head_dim=64, head_dim=96,
        mlp_type="swiglu", tie_embeddings=True,
    )
    base.update(kw)
    return ModelConfig(**base).validate()


def reduced_config(**kw) -> ModelConfig:
    base = dict(
        name="minicpm3-reduced", family="dense", attention="mla",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, head_dim=24,
        mlp_type="swiglu", tie_embeddings=True, attn_chunk=16, loss_chunk=16, remat=False,
    )
    base.update(kw)
    return ModelConfig(**base).validate()
