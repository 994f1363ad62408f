"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``): causal / sliding-window GQA attention with
an online softmax, fp32 or bf16 in, fp32 accumulation, output in the input
dtype.

Two designs serve it, picked up front by :func:`route` from (dtype, D):
"mma" (bf16 at D in ``MMA_HEAD_DIMS``: ``mma.sync`` on the bf16 tensor
cores, which also needs :func:`check_mma_layout`'s alignment) and "simt"
(fp32 FMAs on the CUDA cores: fp32 at every D, bf16 at the other D).  A
route that cannot take its inputs raises; nothing falls back from one
design to the other.

Port of ``repro.kernels.flash_attention.flash_attention``.  The wrapper
takes CUDA tensors only: it checks device, dtype and shapes, allocates the
output, launches on the current stream and raises if the launch fails.
q (B, Hq, S, D), k and v (B, Hkv, S, D) may be strided views (a
``(B, S, H, D)`` tensor transposed to ``(B, H, S, D)`` goes in without a
copy) as long as the feature axis has unit stride; the output takes q's
memory layout (``torch.empty_like``).  ``launches`` counts the launches
it made and ``launches_by_route`` splits them by design; an empty output
launches nothing.  The plain version is
``kernels.ref.flash_attention_ref``; ``kernels.ops.flash_attention``
chooses between the two.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
MMA_HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTE_CODES = {"simt": 0, "mma": 1}
MMA_BLOCK_Q = 64  # query rows per CTA of the mma route (4 warps x 16)

# counts the wrapper's calls that launch: eager launches and those a
# CUDA-graph capture records (the executor's warm); a replay runs no
# wrapper and is not counted here
launches = 0
launches_by_route = dict.fromkeys(ROUTE_CODES, 0)

_SIGNATURES = {
    "flash_attention_fwd": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,) * 12
        + (ctypes.c_int,) * 9 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,),
    ),
}


def route(dtype: torch.dtype, d: int) -> str:
    """The design that serves inputs of ``dtype`` with head dim ``d``:
    "mma" for bf16 at D in ``MMA_HEAD_DIMS``, else "simt"."""
    return "mma" if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS else "simt"


def check_route(name: str, dtype: torch.dtype, d: int) -> None:
    """Raise ValueError unless route ``name`` has an instance for
    (``dtype``, ``d``): "simt" takes every dtype and D the wrapper takes,
    "mma" only bf16 at D in ``MMA_HEAD_DIMS``."""
    if name not in ROUTE_CODES:
        raise ValueError(f"flash_attention: unknown route {name!r}; expected one "
                         f"of {tuple(ROUTE_CODES)}")
    if name == "mma" and route(dtype, d) != "mma":
        raise ValueError(f"flash_attention: the mma route has no instance for "
                         f"{dtype} at D={d} (bf16 at D in {MMA_HEAD_DIMS} only)")


def mma_block_k(d: int, capped: bool = False) -> int:
    """Key rows per KV tile of the mma route: 64, and fewer at D = 256 to fit
    the registers (32; 16 with a softcap)."""
    if d < 256:
        return 64
    return 16 if capped else 32


def mma_smem_bytes(d: int, capped: bool = False) -> int:
    """Dynamic shared memory of the mma route at head dim ``d``: a bf16 Q
    tile and a ring of bf16 K and V tiles, three stages at D <= 128 and two
    at 256 (``csrc``'s ``Cfg::SMEM``)."""
    stages = 3 if d < 256 else 2
    return (MMA_BLOCK_Q + 2 * stages * mma_block_k(d, capped)) * d * 2


def check_mma_layout(*tensors: torch.Tensor) -> None:
    """Raise ValueError unless every (B, H, S, D) tensor starts on a
    16-byte boundary and its batch, head and row strides are multiples of
    8 elements (a stride along an axis of extent 1 is never used): the mma
    route copies 16-byte chunks with ``cp.async``."""
    for t in tensors:
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n != 1]
        if t.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(
                f"flash_attention: the mma route needs 16-byte-aligned data and "
                f"(batch, head, row) strides in multiples of 8 elements; got data "
                f"at {t.data_ptr() % 16} bytes past a 16-byte boundary, strides "
                f"{tuple(t.stride())}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0,
                    force_route: str | None = None) -> torch.Tensor:
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) CUDA tensors, fp32 or bf16,
    Hq % Hkv == 0, D in ``HEAD_DIMS`` -> (B, Hq, S, D); ``window`` None or
    0 attends to the whole causal prefix.  ``force_route`` replaces
    :func:`route`'s choice (to time one design against the other); a route
    with no instance for the inputs raises."""
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
    chosen = route(q.dtype, d) if force_route is None else force_route
    check_route(chosen, q.dtype, d)
    out = torch.empty_like(q)  # q's strides when dense, else contiguous
    if out.numel() == 0:
        return out
    if chosen == "mma":
        check_mma_layout(q, k, v, out)
    lib = _build.load("flash_attention", _SIGNATURES)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with _build.device_scope(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            b, hq, hkv, s, d, int(causal), window, DTYPE_CODES[q.dtype],
            ROUTE_CODES[chosen], 1.0 / math.sqrt(d), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch ({chosen} route) failed: "
                           f"cudaError_t {err}")
    launches += 1
    launches_by_route[chosen] += 1
    return out
