"""Input stand-ins per (architecture x shape) for the dry-run (port of
``repro.launch.specs``): each entry's shape and dtype, from which the
dry-run makes fake tensors (JAX's ``ShapeDtypeStruct``: nothing is
allocated).  Modality frontends are stubs: a VLM takes patch embeddings,
audio post-conv frame embeddings.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype, nothing else (``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    def empty(self, device="cpu") -> torch.Tensor:
        """An uninitialised tensor of this shape and dtype: under a
        ``FakeTensorMode`` a fake one, which holds no memory."""
        return torch.empty(self.shape, dtype=self.dtype, device=device)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training / prefill batch: tokens + modality extras.

    For a VLM the patch stub takes the first ``num_patches`` positions of
    the sequence budget; for audio the tokens are decoder tokens and the
    frames the fixed-length encoder input.
    """
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.family == "vlm":
        specs["tokens"] = ShapeDtype((b, s - cfg.num_patches), torch.int32)
        specs["patches"] = ShapeDtype((b, cfg.num_patches, cfg.d_model), _dt(cfg))
    else:
        specs["tokens"] = ShapeDtype((b, s), torch.int32)
    if cfg.family == "audio":
        specs["frames"] = ShapeDtype((b, cfg.encoder_seq, cfg.d_model), _dt(cfg))
    return specs


def batch_axes(cfg: ModelConfig) -> dict:
    """Logical axes per batch entry (for sharding resolution)."""
    axes = {"tokens": ("batch", "seq")}
    if cfg.family == "vlm":
        axes["patches"] = ("batch", "seq", "embed")
    if cfg.family == "audio":
        axes["frames"] = ("batch", "seq", "embed")
    return axes


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(tokens (B, 1), t ()) for ``decode_step``."""
    return (ShapeDtype((shape.global_batch, 1), torch.int32),
            ShapeDtype((), torch.int32))
