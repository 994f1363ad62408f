"""Wrapper of the ``segment_reduce`` CUDA kernel (``csrc/segment_reduce.cu``):
sum / mean / sqsum / max / min of (E, F) plan-ordered values over the
plan's CSR ranges, fp32; every empty row comes out 0.

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

launches = 0

_SIGNATURES = {
    "segment_reduce_f32": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
    ),
}


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
            num_segments, f, OP_CODES[op], stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_reduce launch failed: cudaError_t {err}")
    launches += 1
    return out
