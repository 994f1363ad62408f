"""Wrapper of the ``node_mlp`` CUDA kernel (``csrc/node_mlp.cu``):
``y = act(x @ w + b)`` in IEEE fp32.

Three variants serve it, picked up front by :func:`variant` from (M, K,
N): "narrow" (N <= ``NARROW_MAX_N``: one warp per output row, a shuffle
reduction over K), "shallow" (K <= ``SHALLOW_MAX_K``: one 16-deep slice
through shared memory) and "tiled" (64 x 64 output tiles fed by a
``cp.async`` ring of 32-deep K slices).

Port of ``repro.kernels.node_mlp.node_mlp``.  The wrapper takes CUDA
tensors only: it checks device, dtype, shape and contiguity, allocates the
output, launches on the current stream and raises if the launch fails.
``launches`` counts the launches it made and ``launches_by_variant``
splits them by variant; an empty output launches nothing.  The plain
version is ``kernels.ref.node_mlp_ref``; ``kernels.ops.node_mlp`` chooses
between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ACTIVATION_CODES = {"none": 0, "relu": 1, "gelu": 2}
VARIANT_CODES = {"narrow": 0, "shallow": 1, "tiled": 2}
NARROW_MAX_N = 8
SHALLOW_MAX_K = 16
# the tiled variant's ring: 32-deep K slices of a 64-row x tile (rows padded
# by 4 floats) and a 64-column w tile, at most 8 slices in flight
TILED_K_SLICE, TILED_MAX_STAGES = 32, 8
TILED_STAGE_BYTES = 4 * (64 * (TILED_K_SLICE + 4) + TILED_K_SLICE * 64)

# counts the wrapper's calls that launch: eager launches and those a
# CUDA-graph capture records (the executor's warm); a replay runs no
# wrapper and is not counted here
launches = 0
launches_by_variant = dict.fromkeys(VARIANT_CODES, 0)

_SIGNATURES = {
    "node_mlp_f32": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,),
    ),
}


def variant(m: int, k: int, n: int) -> str:
    """The kernel variant for an (m, k) x (k, n) product: "narrow" for
    n <= ``NARROW_MAX_N`` (the head's n = 1), "shallow" for k <=
    ``SHALLOW_MAX_K`` (the encoder's k = 9, the edge embedding's k = 3),
    else "tiled"."""
    if n <= NARROW_MAX_N:
        return "narrow"
    return "shallow" if k <= SHALLOW_MAX_K else "tiled"


def tiled_smem_bytes(k: int) -> int:
    """Dynamic shared memory of the tiled variant at depth ``k``: one ring
    stage per K slice, at most ``TILED_MAX_STAGES`` (``csrc``'s launch)."""
    slices = -(-k // TILED_K_SLICE)
    return min(max(slices, 1), TILED_MAX_STAGES) * TILED_STAGE_BYTES


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
    chosen = variant(m, k, n)
    lib = _build.load("node_mlp", _SIGNATURES)
    with _build.device_scope(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.node_mlp_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, k, n, ACTIVATION_CODES[activation], VARIANT_CODES[chosen], stream,
        )
    if err != 0:
        raise RuntimeError(f"node_mlp launch ({chosen} variant) failed: "
                           f"cudaError_t {err}")
    launches += 1
    launches_by_variant[chosen] += 1
    return out
