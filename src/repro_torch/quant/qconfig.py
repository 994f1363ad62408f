"""Quantization schemes and the quantized-parameter representation,
PyTorch port of ``repro.quant.qconfig``.

  * ``"int8"``  — W8A8: per-channel symmetric int8 weights, int8
    activations, int8 x int8 -> int32 accumulate with one fused f32
    requantize tail (``kernels/csrc/quant_mlp.cu`` is the kernel,
    ``kernels/ref.quant_node_mlp_ref`` its plain version).  Activations
    are quantized per row on the device (``act_mode="dynamic"``, no
    calibration) or with one calibrated per-tensor affine scale
    (``act_mode="static"``: observers, zero-point folded into the bias,
    SmoothQuant-style migration folded into the weights).
  * ``"fixed"`` — ``ap_fixed<W,I>`` emulation, the paper's precision knob:
    weights and activations snap to the 2^(I-W) grid with saturation, the
    matmul runs in f32 (the paper's wide accumulator), and the output
    snaps again.

A quantized linear layer is a ``QuantizedLinear`` (a frozen dataclass of
tensors); ``gnn/layers.linear_apply`` dispatches on it, so a transformed
parameter tree runs through all six models with no model-specific code.
An int8-dynamic linear is one call, ``kernels.ops.quant_node_mlp_dynamic``:
on the card one launch quantizes the rows and runs the matmul with its
requantize tail (the JAX package hands the same row recipe to XLA as one
fusion before its kernel); its plain version is
``kernels/ref.quant_node_mlp_dynamic_ref``.  Static activation quantization
is plain tensor code.  Divisions by a constant go through
``core.ieee.div_rn``, so the scales are the IEEE quotients XLA and the CUDA
kernels compute.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.ieee import div_rn
from repro_torch.kernels import ops

SCHEMES = ("int8", "fixed")


@dataclasses.dataclass(frozen=True)
class QConfig:
    """One quantization recipe (a serving ``precision`` resolves to one).

    scheme:       "int8" | "fixed"
    act_mode:     int8 activation scales: "dynamic" (per row, on the
                  device) | "static" (per tensor, from calibration)
    granularity:  weight scales, "per_channel" | "per_tensor"
    observer:     static-mode range estimator, "minmax" | "percentile"
    percentile:   absolute-value percentile of the percentile observer
    asymmetric_acts:  static mode: zero-point activations for one-sided
                  (post-relu) ranges; the correction folds into the bias
    smooth_alpha: static mode: SmoothQuant migration strength for skewed
                  activation columns (0 disables)
    word_bits/int_bits:  the ap_fixed<W,I> knob (scheme="fixed")
    skip:         top-level parameter keys kept in fp32 (the prediction
                  head, by default)
    """

    scheme: str = "int8"
    act_mode: str = "dynamic"
    granularity: str = "per_channel"
    observer: str = "minmax"
    percentile: float = 99.9
    asymmetric_acts: bool = True
    smooth_alpha: float = 0.25
    word_bits: int = 16
    int_bits: int = 6
    skip: Tuple[str, ...] = ("head",)

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; expected {SCHEMES}")
        if self.act_mode not in ("dynamic", "static"):
            raise ValueError(f"unknown act_mode {self.act_mode!r}")
        if self.granularity not in ("per_channel", "per_tensor"):
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if not 1 <= self.int_bits < self.word_bits:
            raise ValueError(
                f"ap_fixed<{self.word_bits},{self.int_bits}> needs "
                f"1 <= int_bits < word_bits"
            )


@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    """A quantized ``{"w", "b"}`` linear layer.

    int8 dynamic: w_q int8 (K, N); w_scale f32 (N,) or (); b f32; the
           activation scales are per row at run time (x_scale / x_zero /
           x_premul unused: 1 / 0 / 1).
    int8 static:  x_scale f32 () and x_zero f32 () from calibration (the
           zero-point's matmul correction is folded into ``b``); x_premul
           f32 (K,) or () SmoothQuant divisor (1 when off).
    fixed: w_q f32 (K, N) on the ap_fixed grid; w_scale / x_scale hold the
           grid's LSB 2^(I-W); b snapped f32; x_premul / x_zero unused.
    """

    w_q: Any
    w_scale: Any
    b: Any
    x_scale: Any
    x_premul: Any = 1.0
    x_zero: Any = 0.0
    scheme: str = "int8"
    act_mode: str = "dynamic"
    word_bits: int = 16
    int_bits: int = 6


# The int8-dynamic contract of the fused kernel too: when a QuantizedLinear
# lowers into ``kernels.ops.fused_mp`` the kernel repeats the dynamic recipe
# ``rs = max(rowmax|x|, _EPS) / 127`` in its gamma, so ``kernels/ref._ROW_EPS``
# and the ``1e-8f`` of ``kernels/csrc/fused_mp.cu`` must equal this constant.
_EPS = 1e-8


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def symmetric_scale(lo, hi, qmax: int = 127) -> torch.Tensor:
    """Symmetric range -> positive quantization step (elementwise)."""
    bound = torch.maximum(torch.abs(_f32(lo)), torch.abs(_f32(hi)))
    return div_rn(torch.clamp(bound, min=_EPS), float(qmax))


def quantize_int8(x: torch.Tensor, scale, zero=0.0) -> torch.Tensor:
    """Round-half-to-even affine int8 with saturation (zero=0: symmetric)."""
    q = torch.round(x.float() / scale) + zero
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def affine_act_params(lo, hi, asymmetric: bool):
    """-> (x_scale, x_zero) of the activation quantizer: zero-point over
    all 256 levels for a mostly one-sided range, else symmetric."""
    lo = float(min(lo, 0.0))
    hi = float(max(hi, 0.0))
    one_sided = (-lo <= 0.25 * hi) or (hi <= 0.25 * -lo)
    if asymmetric and one_sided:
        scale = max(hi - lo, _EPS) / 255.0
        zero = -128.0 - round(lo / scale)
        return scale, zero
    return float(symmetric_scale(lo, hi)), 0.0


def dequantize_int8(x_q: torch.Tensor, scale) -> torch.Tensor:
    return x_q.float() * scale


def fixed_round(x: torch.Tensor, word_bits: int, int_bits: int) -> torch.Tensor:
    """Snap to the ap_fixed<W,I> grid: LSB 2^(I-W), saturating range
    [-2^(I-1), 2^(I-1) - LSB] (I includes the sign bit, as in HLS)."""
    lsb = 2.0 ** (int_bits - word_bits)
    qmax = 2.0 ** (word_bits - 1) - 1.0
    q = torch.clamp(torch.round(x.float() / lsb), -(qmax + 1.0), qmax)
    return q * lsb


def quantize_weight(w: torch.Tensor, qcfg: QConfig):
    """-> (w_q, w_scale) under ``qcfg``."""
    if qcfg.scheme == "fixed":
        lsb = _f32(2.0 ** (qcfg.int_bits - qcfg.word_bits))
        return fixed_round(w, qcfg.word_bits, qcfg.int_bits), lsb
    a = torch.abs(w.float())
    bound = a.amax(dim=0) if qcfg.granularity == "per_channel" else a.amax()
    scale = div_rn(torch.clamp(bound, min=_EPS), 127.0)
    return quantize_int8(w, scale), scale


def quantized_linear(q: QuantizedLinear, x: torch.Tensor,
                     activation: str = "none", mode: str = "auto") -> torch.Tensor:
    """Forward one quantized linear layer: f32 in, f32 out.

    int8 dynamic: per-row (per-node) exact-range scales and the int8 rows
    computed with the product in one kernel call, requantized by
    ``(acc * w_scale) * row_scale`` in its tail.  int8
    static: SmoothQuant divisor, calibrated (scale, zero-point), requantize
    by ``x_scale * w_scale``.  fixed: snap the input, fp32 NE PE, snap the
    output.
    """
    if q.scheme == "fixed":
        x_f = fixed_round(x, q.word_bits, q.int_bits)
        y = ops.node_mlp(x_f, q.w_q, q.b, activation=activation, mode=mode)
        return fixed_round(y, q.word_bits, q.int_bits)
    if q.act_mode == "dynamic":
        return ops.quant_node_mlp_dynamic(x, q.w_q, q.w_scale, q.b,
                                          activation=activation, mode=mode)
    x_q = quantize_int8(x * q.x_premul, q.x_scale, q.x_zero)
    scale = (q.x_scale * q.w_scale).float()
    return ops.quant_node_mlp(x_q, q.w_q, scale, q.b, activation=activation,
                              mode=mode)
