"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``): causal / sliding-window GQA attention with
an online softmax, fp32 or bf16 in, fp32 accumulation, output in the input
dtype.

The query / key head dim D and the value head dim Dv are separate: Dv = D
at D in ``HEAD_DIMS``, or a pair of ``MLA_HEAD_DIMS`` (MiniCPM3's prefill:
D 96 = nope 64 + rope 32, Dv 64); the scale is 1 / sqrt(D), as JAX's
``blocked_attention`` takes it.  Two designs serve it, picked up front by
:func:`route` from (dtype, D, Dv): "mma" (bf16 at D in ``MMA_HEAD_DIMS``
with Dv = D, or at an MLA pair: ``mma.sync`` on the bf16 tensor cores,
which also needs :func:`check_mma_layout`'s alignment) and "simt" (fp32
FMAs on the CUDA cores: fp32 at every pair, bf16 at the other D).  A route
that cannot take its inputs raises; nothing falls back from one design to
the other, and a pair with no instance is refused (no padding to a wider
head).

Port of ``repro.kernels.flash_attention.flash_attention``.  The wrapper
takes CUDA tensors only: it checks device, dtype and shapes, allocates the
output, launches on the current stream and raises if the launch fails.
q (B, Hq, S, D), k (B, Hkv, S, D) and v (B, Hkv, S, Dv) may be strided
views (a ``(B, S, H, D)`` tensor transposed to ``(B, H, S, D)`` goes in
without a copy) as long as the feature axis has unit stride; the output
(B, Hq, S, Dv) takes q's axis order (a transposed ``(B, S, H, D)`` q gives
an output whose ``(B, S, H, Dv)`` view is contiguous).  ``launches``
counts the launches it made and ``launches_by_route`` splits them by
design; an empty output launches nothing.  The plain version is
``kernels.ref.flash_attention_ref``; ``kernels.ops.flash_attention``
chooses between the two.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # Dv = D
MMA_HEAD_DIMS = (64, 128, 256)
MLA_HEAD_DIMS = ((96, 64),)  # (D, Dv) pairs with Dv < D: both routes
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
        + (ctypes.c_int,) * 10 + (ctypes.c_float,) * 2 + (ctypes.c_void_p,),
    ),
}


def has_instance(d: int, dv: int | None = None) -> bool:
    """Whether the kernel has an instance for head dims (``d``, ``dv``)
    (``dv`` None: ``d``)."""
    dv = d if dv is None else dv
    return (dv == d and d in HEAD_DIMS) or (d, dv) in MLA_HEAD_DIMS


def route(dtype: torch.dtype, d: int, dv: int | None = None) -> str:
    """The design that serves inputs of ``dtype`` with query / key head dim
    ``d`` and value head dim ``dv`` (None: ``d``): "mma" for bf16 at D in
    ``MMA_HEAD_DIMS`` with Dv = D or at a pair of ``MLA_HEAD_DIMS``, else
    "simt"."""
    dv = d if dv is None else dv
    mma = (dv == d and d in MMA_HEAD_DIMS) or (d, dv) in MLA_HEAD_DIMS
    return "mma" if dtype == torch.bfloat16 and mma else "simt"


def check_route(name: str, dtype: torch.dtype, d: int, dv: int | None = None) -> None:
    """Raise ValueError unless route ``name`` has an instance for
    (``dtype``, ``d``, ``dv``): "simt" takes every dtype and head dims the
    wrapper takes, "mma" only bf16 at D in ``MMA_HEAD_DIMS`` (Dv = D) or at
    a pair of ``MLA_HEAD_DIMS``."""
    if name not in ROUTE_CODES:
        raise ValueError(f"flash_attention: unknown route {name!r}; expected one "
                         f"of {tuple(ROUTE_CODES)}")
    if name == "mma" and route(dtype, d, dv) != "mma":
        raise ValueError(f"flash_attention: the mma route has no instance for "
                         f"{dtype} at D={d}, Dv={d if dv is None else dv} (bf16 at D "
                         f"in {MMA_HEAD_DIMS} with Dv = D, or (D, Dv) in "
                         f"{MLA_HEAD_DIMS}, only)")


def mma_block_k(d: int, capped: bool = False) -> int:
    """Key rows per KV tile of the mma route: 64, and fewer at D = 256 to fit
    the registers (32; 16 with a softcap)."""
    if d < 256:
        return 64
    return 16 if capped else 32


def mma_pitch(d: int) -> int:
    """Elements per row of a bf16 tile of ``d`` columns in the mma route's
    shared memory: ``d`` (XOR-swizzled) at d % 64 == 0, else ``d`` plus one
    8-element chunk of padding (``csrc``'s ``Tile::PITCH``)."""
    return d if d % 64 == 0 else d + 8


def mma_smem_bytes(d: int, capped: bool = False, dv: int | None = None) -> int:
    """Dynamic shared memory of the mma route at head dims (``d``, ``dv``)
    (``dv`` None: ``d``): a bf16 Q tile and a ring of bf16 K and V tiles,
    three stages at D <= 128 and two at 256, rows ``mma_pitch`` long
    (``csrc``'s ``Cfg::SMEM``)."""
    dv = d if dv is None else dv
    stages = 3 if d < 256 else 2
    pq, pv = mma_pitch(d), mma_pitch(dv)
    return (MMA_BLOCK_Q * pq + stages * mma_block_k(d, capped) * (pq + pv)) * 2


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
    """q (B, Hq, S, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv) CUDA tensors,
    fp32 or bf16, Hq % Hkv == 0, Dv = D in ``HEAD_DIMS`` or (D, Dv) in
    ``MLA_HEAD_DIMS`` -> (B, Hq, S, Dv); ``window`` None or 0 attends to the
    whole causal prefix.  ``force_route`` replaces
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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need (B, Hkv, S, D), Hq % Hkv == 0)")
    if not has_instance(d, dv):
        raise ValueError(f"flash_attention: no instance for head dims D={d}, Dv={dv} "
                         f"(Dv = D in {HEAD_DIMS}, or (D, Dv) in {MLA_HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the feature axis must have unit stride")
    window = int(window or 0)
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window}, softcap {softcap}")
    chosen = route(q.dtype, d, dv) if force_route is None else force_route
    check_route(chosen, q.dtype, d, dv)
    # q's axis order (the stable sort keeps B, H, S where strides tie)
    order = sorted(range(3), key=lambda i: -q.stride(i)) + [3]
    out = torch.empty_permuted((b, hq, s, dv), order, dtype=q.dtype, device=q.device)
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
            b, hq, hkv, s, d, dv, int(causal), window, DTYPE_CODES[q.dtype],
            ROUTE_CODES[chosen], 1.0 / math.sqrt(d), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch ({chosen} route) failed: "
                           f"cudaError_t {err}")
    launches += 1
    launches_by_route[chosen] += 1
    return out
