"""Wrapper of the ``edge_softmax`` CUDA kernel (``csrc/edge_softmax.cu``):
GAT's per-destination, per-head softmax of (E_pad, H) plan-ordered logits
over the plan's CSR ranges, fp32; padding edges get weight 0.  A thread
serves one (destination, head) of up to ``THREAD_EDGES`` edges; the warp
serves a longer segment, from registers up to ``WARP_EDGES`` edges.

Port of ``repro.kernels.edge_softmax.edge_softmax``.  The wrapper takes
CUDA tensors only: it checks device, dtype, shape and contiguity, allocates
the output, launches on the current stream and raises if the launch fails.
``launches`` counts the launches it made; an empty output launches
nothing.  The plain version is ``kernels.ref.edge_softmax_ref``, which
reads the sorted ids where the kernel walks ``offsets``;
``kernels.ops.edge_softmax`` chooses.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# the kernel's segment lengths (csrc/edge_softmax.cu): a thread's, and the
# longest a warp holds in registers (longer ones are read three times)
THREAD_EDGES = 16
WARP_EDGES = 512

# counts the wrapper's calls that launch: eager launches and those a
# CUDA-graph capture records (the executor's warm); a replay runs no
# wrapper and is not counted here
launches = 0

_SIGNATURES = {
    "edge_softmax_f32": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
    ),
    "edge_softmax_blocks": (
        ctypes.c_longlong, (ctypes.c_int,) * 3 + (ctypes.POINTER(ctypes.c_int),),
    ),
}


def launch_shape(n: int, h: int, e_pad: int) -> tuple:
    """(blocks, threads a destination takes) of the kernel's launch, as the
    CUDA source computes them (built and loaded on first use)."""
    group = ctypes.c_int()
    blocks = _build.load("edge_softmax", _SIGNATURES).edge_softmax_blocks(
        n, h, e_pad, ctypes.byref(group))
    return blocks, group.value


def edge_softmax(logits: torch.Tensor, offsets: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """logits (E_pad, H) float32 in plan order, offsets (N + 1,) int32 CUDA
    tensors -> (E_pad, H) attention weights."""
    global launches
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"edge_softmax kernel needs CUDA tensors, got {dev}")
    _build.check("edge_softmax", "logits", logits, dev, torch.float32, (None, None))
    _build.check("edge_softmax", "offsets", offsets, dev, torch.int32,
                 (num_segments + 1,))
    e_pad, h = logits.shape
    out = torch.empty((e_pad, h), dtype=torch.float32, device=dev)
    if e_pad == 0 or h == 0:
        return out
    lib = _build.load("edge_softmax", _SIGNATURES)
    with _build.device_scope(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.edge_softmax_f32(
            offsets.data_ptr(), logits.data_ptr(), out.data_ptr(),
            num_segments, h, e_pad, stream,
        )
    if err != 0:
        raise RuntimeError(f"edge_softmax launch failed: cudaError_t {err}")
    launches += 1
    return out
