"""Wrapper of the ``quant_node_mlp`` CUDA kernel (``csrc/quant_mlp.cu``):
``y = act((x_q @ w_q) * scale * row_scale + b)`` with int32 accumulation
on the tensor cores.

Two entries share the kernel's product and tail:

  * :func:`quant_node_mlp` ("static"): int8 ``x_q`` with optional per-row
    scales; the port of ``repro.kernels.quant_mlp.quant_node_mlp``, which
    int8-static linears launch;
  * :func:`quant_node_mlp_dynamic` ("dynamic"): fp32 ``x``, quantized per
    row inside the kernel by ``quant.qconfig``'s int8-dynamic recipe, so an
    int8-dynamic linear is one launch.

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, broadcast a scalar scale to (N,), allocate the output, launch
on the current stream and raise if the launch fails.  ``launches`` counts
the launches made and ``launches_by_entry`` splits them by entry; an empty
output launches nothing.  K and N are bounded by one block's shared memory
(at N = 256: w whole up to K = 640, a ring of w slices past it, refused
past K = 2559 for int8 x, 3392 for fp32 x): past it the kernel refuses the
launch and the wrapper raises ``ValueError``.  The plain versions are
``kernels.ref.quant_node_mlp_ref`` and ``quant_node_mlp_dynamic_ref``;
``kernels.ops`` chooses between kernel and plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.node_mlp import ACTIVATION_CODES

ENTRIES = ("static", "dynamic")
BLOCK_M, BLOCK_N = 32, 256  # csrc/quant_mlp.cu: output rows and columns a block
_INVALID_VALUE = 1  # cudaErrorInvalidValue: K or N past one block's shared memory

# counts the wrapper's calls that launch: eager launches and those a
# CUDA-graph capture records (the executor's warm); a replay runs no
# wrapper and is not counted here
launches = 0
launches_by_entry = dict.fromkeys(ENTRIES, 0)

_SIGNATURES = {
    "quant_mlp_i8": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,),
    ),
    "quant_mlp_dyn_f32": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,),
    ),
}


def blocks(m: int, n: int) -> int:
    """Blocks of a launch at (M, N): 32 rows by up to 256 columns."""
    return -(-m // BLOCK_M) * -(-n // BLOCK_N)


def _operands(name: str, x, dtype, w_q, scale, b, activation: str):
    """Check the operands shared by both entries; -> (m, k, n, scale)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    check = lambda arg, t, dt, shape: _build.check(name, arg, t, dev, dt, shape)
    check("x_q" if dtype == torch.int8 else "x", x, dtype, (None, None))
    m, k = x.shape
    check("w_q", w_q, torch.int8, (k, None))
    n = w_q.shape[1]
    if scale is not None and scale.dim() == 0:
        scale = scale.expand(n).contiguous()
    check("scale" if dtype == torch.int8 else "w_scale", scale, torch.float32, (n,))
    check("b", b, torch.float32, (n,))
    return m, k, n, scale


def _launch(fn: str, entry: str, args, dev) -> None:
    global launches
    lib = _build.load("quant_mlp", _SIGNATURES)
    with _build.device_scope(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err == _INVALID_VALUE:
        raise ValueError(f"quant_node_mlp ({entry} entry): K = {args[-4]}, N = "
                         f"{args[-3]} pass one block's shared memory")
    if err != 0:
        raise RuntimeError(f"quant_node_mlp launch ({entry} entry) failed: "
                           f"cudaError_t {err}")
    launches += 1
    launches_by_entry[entry] += 1


def quant_node_mlp(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                   b: torch.Tensor, activation: str = "relu",
                   row_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8, scale (N,) or () f32, b (N,) f32,
    row_scale (M, 1) f32 or None, all CUDA tensors -> (M, N) f32."""
    m, k, n, scale = _operands("quant_node_mlp", x_q, torch.int8, w_q, scale, b,
                               activation)
    if row_scale is not None:
        _build.check("quant_node_mlp", "row_scale", row_scale, x_q.device,
                     torch.float32, (m, 1))
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    _launch("quant_mlp_i8", "static", (
        x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        None if row_scale is None else row_scale.data_ptr(), b.data_ptr(),
        out.data_ptr(), m, k, n, ACTIVATION_CODES[activation]), x_q.device)
    return out


def quant_node_mlp_dynamic(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor, b: torch.Tensor,
                           activation: str = "none") -> torch.Tensor:
    """x (M, K) f32, w_q (K, N) int8, w_scale (N,) or () f32, b (N,) f32,
    all CUDA tensors -> (M, N) f32: each row of x quantized to int8 at
    ``rs = max(max|x_row|, 1e-8) / 127`` in the kernel, then
    ``act(((x_q @ w_q) * w_scale) * rs + b)``."""
    m, k, n, w_scale = _operands("quant_node_mlp_dynamic", x, torch.float32, w_q,
                                 w_scale, b, activation)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    _launch("quant_mlp_dyn_f32", "dynamic", (
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), b.data_ptr(),
        out.data_ptr(), m, k, n, ACTIVATION_CODES[activation]), x.device)
    return out
