"""Shared building blocks of the GNN models, PyTorch port of
``repro.gnn.layers`` (fp32 only).

Parameters are plain nested dicts of tensors.  Every dense transform
routes through ``kernels.ops.node_mlp``, so the NE PE kernel / plain
dispatch is uniform across models.  Quantized linears arrive with the
int8 slice; a parameter that is not a plain ``{"w", "b"}`` dict raises.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels import ops


def _plain_linear(p) -> bool:
    return isinstance(p, dict) and set(p) == {"w", "b"}


def _require_plain(p) -> None:
    if not _plain_linear(p):
        raise NotImplementedError(
            "quantized linears arrive with the int8 serving slice; this "
            "slice serves fp32 {'w', 'b'} linears only"
        )


def glorot(gen: torch.Generator, shape, device="cpu") -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return (torch.randn(shape, generator=gen) * scale).to(device)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, device="cpu") -> dict:
    return {"w": glorot(gen, (d_in, d_out), device),
            "b": torch.zeros((d_out,), device=device)}


def linear_apply(p, x: torch.Tensor, activation: str = "none",
                 mode: str = "auto") -> torch.Tensor:
    """Dense transform through the NE PE."""
    _require_plain(p)
    return ops.node_mlp(x, p["w"], p["b"], activation=activation, mode=mode)


def fused_linear_operands(p):
    """A linear layer's operand form for the fused kernel:
    ``{"kind": "fp32", "w", "b"}``."""
    _require_plain(p)
    return {"kind": "fp32", "w": p["w"], "b": p["b"]}


def fused_dequant_weights(p):
    """f32 ``(w, b)`` view of a linear layer (GIN's edge embedding and
    second MLP layer in the fused path)."""
    _require_plain(p)
    return p["w"], p["b"]


def mlp_init(gen: torch.Generator, sizes: Sequence[int], device="cpu") -> list:
    """sizes = (d_in, h1, ..., d_out)."""
    return [linear_init(gen, a, b, device) for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(ps: list, x: torch.Tensor, activation: str = "relu",
              mode: str = "auto", final_activation: str = "none") -> torch.Tensor:
    """The paper's MLP PE: linear -> act chain with fused tails."""
    for i, p in enumerate(ps):
        act = activation if i < len(ps) - 1 else final_activation
        x = linear_apply(p, x, activation=act, mode=mode)
    return x


def batch_norm_init(dim: int, device="cpu") -> dict:
    """Inference-mode batch norm (folded scale/shift)."""
    return {"scale": torch.ones((dim,), device=device),
            "shift": torch.zeros((dim,), device=device)}


def batch_norm_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x * p["scale"] + p["shift"]
