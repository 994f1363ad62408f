"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``): causal / sliding-window GQA attention with
an online softmax, fp32 or bf16 in, fp32 arithmetic, output in the input
dtype.

Port of ``repro.kernels.flash_attention.flash_attention``.  The wrapper
takes CUDA tensors only: it checks device, dtype and shapes, allocates the
output, launches on the current stream and raises if the launch fails.
q (B, Hq, S, D), k and v (B, Hkv, S, D) may be strided views (a
``(B, S, H, D)`` tensor transposed to ``(B, H, S, D)`` goes in without a
copy) as long as the feature axis has unit stride; the output takes q's
memory layout (``torch.empty_like``).  ``launches`` counts the launches
it made; an empty output launches nothing.  The plain version is
``kernels.ref.flash_attention_ref``; ``kernels.ops.flash_attention``
chooses between the two.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_SIGNATURES = {
    "flash_attention_fwd": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) * 12
        + (ctypes.c_int,) * 8 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,),
    ),
}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) CUDA tensors, fp32 or bf16,
    Hq % Hkv == 0, D in ``HEAD_DIMS`` -> (B, Hq, S, D); ``window`` None or
    0 attends to the whole causal prefix."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not one of "
                        f"{tuple(DTYPE_CODES)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need (B, Hkv, S, D), Hq % Hkv == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the feature axis must have unit stride")
    window = int(window or 0)
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window}, softcap {softcap}")
    out = torch.empty_like(q)  # q's strides when dense, else contiguous
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _SIGNATURES)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with _build.device_scope(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            b, hq, hkv, s, d, int(causal), window, DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(d), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    launches += 1
    return out
