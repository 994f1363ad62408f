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


def node_mlp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             activation: str = "relu") -> torch.Tensor:
    """x (M, K), w (K, N), b (N,) float32 CUDA tensors -> (M, N)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"node_mlp kernel needs CUDA tensors, got {x.device}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    for name, t, dim in (("x", x, 2), ("w", w, 2), ("b", b, 1)):
        _build.check("node_mlp", name, t, x.device, torch.float32, (None,) * dim)
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
