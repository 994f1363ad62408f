"""Wrapper of the ``quant_node_mlp`` CUDA kernel (``csrc/quant_mlp.cu``):
``y = act((x_q @ w_q) * scale * row_scale + b)`` with int32 accumulation.

Port of ``repro.kernels.quant_mlp.quant_node_mlp``.  The wrapper takes
CUDA tensors only: it checks device, dtype, shape and contiguity,
broadcasts a scalar ``scale`` to (N,), allocates the output, launches on
the current stream and raises if the launch fails.  ``launches`` counts
the launches it made; an empty output launches nothing.  The plain
version is ``kernels.ref.quant_node_mlp_ref``; ``kernels.ops.quant_node_mlp``
chooses between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.node_mlp import ACTIVATION_CODES

launches = 0

_SIGNATURES = {
    "quant_mlp_i8": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,),
    ),
}


def quant_node_mlp(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                   b: torch.Tensor, activation: str = "relu",
                   row_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8, scale (N,) or () f32, b (N,) f32,
    row_scale (M, 1) f32 or None, all CUDA tensors -> (M, N) f32."""
    global launches
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"quant_node_mlp kernel needs CUDA tensors, got {dev}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    check = lambda name, t, dtype, shape: _build.check(
        "quant_node_mlp", name, t, dev, dtype, shape)
    i8, f32 = torch.int8, torch.float32
    check("x_q", x_q, i8, (None, None))
    m, k = x_q.shape
    check("w_q", w_q, i8, (k, None))
    n = w_q.shape[1]
    if scale is not None and scale.dim() == 0:
        scale = scale.expand(n).contiguous()
    check("scale", scale, f32, (n,))
    check("b", b, f32, (n,))
    if row_scale is not None:
        check("row_scale", row_scale, f32, (m, 1))
    out = torch.empty((m, n), dtype=f32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = _build.load("quant_mlp", _SIGNATURES)
    with _build.device_scope(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.quant_mlp_i8(
            x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(),
            b.data_ptr(), out.data_ptr(), m, k, n,
            ACTIVATION_CODES[activation], stream,
        )
    if err != 0:
        raise RuntimeError(f"quant_node_mlp launch failed: cudaError_t {err}")
    launches += 1
    return out
