"""Shared building blocks of the GNN models, PyTorch port of
``repro.gnn.layers``.

Parameters are plain nested dicts of tensors.  Every dense transform
routes through ``linear_apply``: a plain ``{"w", "b"}`` dict runs the NE PE
(``kernels.ops.node_mlp``), a ``quant.QuantizedLinear`` its quantized
forward (``kernels.ops.quant_node_mlp_dynamic`` for int8-dynamic,
``kernels.ops.quant_node_mlp`` for int8-static), so the kernel / plain
dispatch is uniform across models and precisions.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.quant import observers as qobs
from repro_torch.quant import qconfig as qc


def glorot(gen: torch.Generator, shape, device="cpu") -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    scale = math.sqrt(2.0 / (fan_in + fan_out))
    return (torch.randn(shape, generator=gen) * scale).to(device)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, device="cpu") -> dict:
    return {"w": glorot(gen, (d_in, d_out), device),
            "b": torch.zeros((d_out,), device=device)}


def linear_apply(p, x: torch.Tensor, activation: str = "none",
                 mode: str = "auto") -> torch.Tensor:
    """Dense transform through the NE PE; a ``QuantizedLinear`` runs its
    quantized forward.  fp32 inputs are reported to the calibration hook
    (a no-op outside ``quant.apply.calibrate``)."""
    if isinstance(p, qc.QuantizedLinear):
        return qc.quantized_linear(p, x, activation=activation, mode=mode)
    qobs.observe_linear_input(p, x)
    return ops.node_mlp(x, p["w"], p["b"], activation=activation, mode=mode)


def fused_linear_operands(p):
    """A linear layer's operand form for the fused kernel, or ``None``:

      {"kind": "fp32", "w", "b"}               plain ``{"w", "b"}``
      {"kind": "int8", "w_q", "w_scale", "b"}  int8-dynamic (w_scale (N,))

    ``None`` (int8-static, "fixed": neither folds into the kernel's
    requantize tail) tells the layer body to keep the unfused path.
    """
    if isinstance(p, qc.QuantizedLinear):
        if p.scheme == "int8" and p.act_mode == "dynamic":
            return {"kind": "int8", "w_q": p.w_q,
                    "w_scale": p.w_scale.float().expand(p.w_q.shape[1]),
                    "b": p.b}
        return None
    return {"kind": "fp32", "w": p["w"], "b": p["b"]}


def fused_dequant_weights(p):
    """f32 ``(w, b)`` view of a linear layer (GIN's edge embedding and
    second MLP layer in the fused path: int8-dynamic weights run
    dequantized there), or ``None`` for int8-static / "fixed"."""
    if isinstance(p, qc.QuantizedLinear):
        if p.scheme == "int8" and p.act_mode == "dynamic":
            return qc.dequantize_int8(p.w_q, p.w_scale), p.b
        return None
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
