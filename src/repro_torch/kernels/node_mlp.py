"""Wrapper of the ``node_mlp`` CUDA kernel (``csrc/node_mlp.cu``):
``y = act(x @ w + b)`` in IEEE fp32.

Port of ``repro.kernels.node_mlp.node_mlp``.  The wrapper takes CUDA
tensors only: it checks device, dtype, shape and contiguity, allocates the
output, launches on the current stream and raises if the launch fails.
``launches`` counts the launches it made; an empty output launches
nothing.  The plain version is
``kernels.ref.node_mlp_ref``; ``kernels.ops.node_mlp`` chooses between the
two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ACTIVATION_CODES = {"none": 0, "relu": 1, "gelu": 2}

launches = 0

_SIGNATURES = {
    "node_mlp_f32": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,),
    ),
}


def _check(name: str, t: torch.Tensor, dim: int, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"node_mlp: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"node_mlp: {name} must be float32, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"node_mlp: {name} must be {dim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"node_mlp: {name} must be contiguous")


def node_mlp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             activation: str = "relu") -> torch.Tensor:
    """x (M, K), w (K, N), b (N,) float32 CUDA tensors -> (M, N)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"node_mlp kernel needs CUDA tensors, got {x.device}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    _check("x", x, 2, x.device)
    _check("w", w, 2, x.device)
    _check("b", b, 1, x.device)
    m, k = x.shape
    if w.shape[0] != k or b.shape[0] != w.shape[1]:
        raise ValueError(
            f"node_mlp: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b {tuple(b.shape)} do not chain"
        )
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load("node_mlp", _SIGNATURES)
    with _build.device_scope(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.node_mlp_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, k, n, ACTIVATION_CODES[activation], stream,
        )
    if err != 0:
        raise RuntimeError(f"node_mlp launch failed: cudaError_t {err}")
    launches += 1
    return out
