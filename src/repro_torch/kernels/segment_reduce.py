"""Wrapper of the ``segment_reduce`` CUDA kernel (``csrc/segment_reduce.cu``):
sum / mean / sqsum / max / min of (E, F) plan-ordered values over the
plan's CSR ranges, fp32; every empty row comes out 0.  A thread reads
``vector_width`` consecutive features of a row at a time: 4 (float4) where
F is a multiple of 4 and ``values`` and the output are 16-byte aligned, 2
(float2) at 8 bytes, else 1; every width gives the same bits.

Port of ``repro.kernels.segment_reduce.segment_reduce_sorted`` plus the
finalisation ``repro.kernels.ops.segment_reduce`` does around it.  The
wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream and
raises if the launch fails.  ``launches`` counts the launches it made; an
empty output launches nothing.  The plain version is
``kernels.ref.segment_reduce_sorted_ref``, which reads the sorted ids where
the kernel walks ``offsets``; ``kernels.ops.segment_reduce`` chooses.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

OP_CODES = {"sum": 0, "mean": 1, "sqsum": 2, "max": 3, "min": 4}

# counts the wrapper's calls that launch: eager launches and those a
# CUDA-graph capture records (the executor's warm); a replay runs no
# wrapper and is not counted here
launches = 0

_SIGNATURES = {
    "segment_reduce_f32": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,),
    ),
    "segment_reduce_blocks": (
        ctypes.c_longlong, (ctypes.c_int,) * 3 + (ctypes.POINTER(ctypes.c_int),),
    ),
}


def vector_width(f: int, *tensors: torch.Tensor) -> int:
    """Features a thread reads at a time: 4 where ``f`` is a multiple of 4
    and every tensor's data is 16-byte aligned, 2 where ``f`` is even and
    they are 8-byte aligned, else 1."""
    for vec in (4, 2):
        if f % vec == 0 and all(t.data_ptr() % (4 * vec) == 0 for t in tensors):
            return vec
    return 1


def launch_shape(n: int, f: int, vec: int) -> tuple:
    """(blocks, threads a destination takes) of the kernel's launch for
    ``n`` destinations of ``f`` features read ``vec`` at a time, as the
    CUDA source computes them (built and loaded on first use)."""
    group = ctypes.c_int()
    blocks = _build.load("segment_reduce", _SIGNATURES).segment_reduce_blocks(
        n, f, vec, ctypes.byref(group))
    return blocks, group.value


def segment_reduce(values: torch.Tensor, offsets: torch.Tensor,
                   num_segments: int, op: str = "sum") -> torch.Tensor:
    """values (E, F) float32 in plan order, offsets (N + 1,) int32 CUDA
    tensors -> (N, F)."""
    global launches
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce kernel needs CUDA tensors, got {dev}")
    if op not in OP_CODES:
        raise ValueError(f"unknown op {op!r}; expected one of {tuple(OP_CODES)}")
    _build.check("segment_reduce", "values", values, dev, torch.float32, (None, None))
    _build.check("segment_reduce", "offsets", offsets, dev, torch.int32,
                 (num_segments + 1,))
    f = values.shape[1]
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    if num_segments == 0 or f == 0:
        return out
    lib = _build.load("segment_reduce", _SIGNATURES)
    with _build.device_scope(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_reduce_f32(
            offsets.data_ptr(), values.data_ptr(), out.data_ptr(),
            num_segments, f, OP_CODES[op], vector_width(f, values, out), stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_reduce launch failed: cudaError_t {err}")
    launches += 1
    return out
