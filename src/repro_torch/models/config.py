"""Model configuration (port of ``repro.models.config``).

A copy of the JAX package's ``ModelConfig``, ``ShapeConfig`` and
``SHAPES``, so configs and their derived properties (``head_dim_``,
``kv_heads_effective``, ``group_size``, ``window_for_layer``,
``mixer_kind``, ``ffn_kind``) are the same objects on both sides.  Layer
heterogeneity (Gemma-3's 5:1 local:global) is a periodic pattern: layers
are grouped into super-blocks of ``group_size`` layers and parameters are
stacked over the ``num_layers / group_size`` groups.  The port's stack
runs the groups as a Python loop whatever ``stack_mode`` says, and
``use_flash_kernel`` is carried over and left unread, as in JAX: the
port's ``blocked_attention`` is the hand-written flash kernel on the card
and its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # --- attention ---
    attention: str = "gqa"  # gqa | mla | none
    causal: bool = True  # False = bidirectional (whisper encoder)
    rope_theta: float = 1e4
    rope_fraction: float = 1.0  # chatglm "2d rope": rotate this fraction of dims
    qk_norm: bool = False  # qwen3
    # Replicate KV heads up to this count at apply time (0 = off).  With
    # kv_heads < TP width, plain replication makes the KV-grad reduction an
    # all-reduce of the (B,S,H,hd) f32 expansion (~6 GB/layer measured);
    # repeating the (tiny) KV projection weights to the TP width keeps the
    # expansion device-local.  Training dynamics are IDENTICAL (gradients
    # of tied copies sum), so this is a distribution detail, not a model
    # change.  Set to the production TP width (16) in full-size configs.
    kv_pad_to: int = 0
    sliding_window: int = 0  # 0 = full; >0 = SWA (mixtral, gemma3 local layers)
    global_every: int = 0  # gemma3: layer i is global iff i % global_every == global_offset
    global_offset: int = 0
    logit_softcap: float = 0.0

    # --- MLA (minicpm3 / deepseek-style) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # layer i uses MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    norm_topk: bool = False  # qwen3 renormalizes top-k router probs

    # --- hybrid / SSM ---
    attn_every: int = 0  # 0 = attention everywhere; else attn iff i % attn_every == attn_offset
    attn_offset: int = 0
    ssm_type: str = "mamba"  # mamba | rwkv6 (mixer for non-attention layers)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    rwkv_head_dim: int = 64
    ssm_chunk: int = 256

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # e.g. 1500 mel frames (post-conv stub)

    # --- VLM backbone (internvl2) ---
    num_patches: int = 0  # patch-embedding stub length

    # --- MLP / misc ---
    mlp_type: str = "swiglu"  # swiglu | gelu | geglu | relu_sq (rwkv channel mix)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # --- execution knobs (not architecture) ---
    stack_mode: str = "scan"  # scan | unroll (unroll => trip-count-faithful HLO)
    remat: bool = True
    attn_chunk: int = 4096  # q/kv block for the chunked-attention jnp path
    loss_chunk: int = 512  # sequence chunk for the vocab-sharded CE loss
    use_flash_kernel: bool = False  # Pallas path (TPU deployment); jnp otherwise
    moe_impl: str = "dispatch"  # dispatch (scatter-gather, paper technique) | dense

    # ---------------- derived ----------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def kv_heads_effective(self) -> int:
        """KV head count after tied-copy padding (cache layout uses this)."""
        if (
            self.kv_pad_to > self.num_kv_heads
            and self.kv_pad_to % self.num_kv_heads == 0
            and self.num_heads % self.kv_pad_to == 0
        ):
            return self.kv_pad_to
        return self.num_kv_heads

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def mixer_kind(self, i: int) -> str:
        """'attn' | 'mamba' | 'rwkv6' for decoder layer i."""
        if self.attention == "none":
            return self.ssm_type
        if self.attn_every and i % self.attn_every != self.attn_offset:
            return self.ssm_type
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'moe' | 'mlp' for decoder layer i."""
        if self.num_experts and i % self.moe_every == self.moe_offset:
            return "moe"
        return "mlp"

    def window_for_layer(self, i: int) -> int:
        """Sliding window (0 = full attention) for decoder layer i."""
        if self.global_every:
            is_global = i % self.global_every == self.global_offset
            return 0 if is_global else self.sliding_window
        return self.sliding_window

    @property
    def group_size(self) -> int:
        """Smallest period after which the layer pattern repeats."""
        p = 1
        if self.attn_every:
            p = _lcm(p, self.attn_every)
        if self.num_experts and self.moe_every > 1:
            p = _lcm(p, self.moe_every)
        if self.global_every:
            p = _lcm(p, self.global_every)
        return p

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.group_size == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern period {self.group_size}"
        )
        return self.num_layers // self.group_size

    @property
    def is_sub_quadratic(self) -> bool:
        """True if per-token decode cost is bounded (SSM / hybrid / windowed)."""
        if self.attention == "none":
            return True
        if self.attn_every:  # hybrid: attention layers still O(S) per token,
            return True  # but the 1:7 interleave bounds the constant (jamba)
        if self.sliding_window and not self.global_every:
            return True  # pure SWA (mixtral)
        if self.global_every and self.sliding_window:
            return True  # 5:1 local:global (gemma3) — documented approximation
        return False

    def validate(self) -> "ModelConfig":
        if self.attention == "mla":
            assert self.kv_lora_rank and self.qk_nope_dim and self.qk_rope_dim
        if self.num_experts:
            assert self.experts_per_token > 0
        _ = self.num_groups  # divisibility check
        for i in range(self.group_size):
            for g in range(1, min(self.num_groups, 2)):
                j = g * self.group_size + i
                if j < self.num_layers:
                    assert self.mixer_kind(i) == self.mixer_kind(j), (i, j)
                    assert self.ffn_kind(i) == self.ffn_kind(j), (i, j)
        return self


def _lcm(a: int, b: int) -> int:
    from math import gcd

    return a * b // gcd(a, b)


# ---------------------------------------------------------------------------
# Input shape sets (the four assigned shapes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
