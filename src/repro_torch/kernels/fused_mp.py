"""Wrapper of the ``fused_mp`` CUDA kernel (``csrc/fused_mp.cu``): one whole
(phi, A, gamma) message-passing layer in one pass over the CSR plan.

Port of ``repro.kernels.fused_mp.fused_mp``: all four gammas (gcn, gin,
pna, dgn), all five accumulators (sum, sqsum, max, min, wsum), and both
precisions — under ``spec.precision="int8"`` gamma's first linear takes
int8 ``w1`` with per-column f32 ``w1_scale`` and quantizes its input per
row inside the pass (gcn's gamma has no linear, so precision changes
nothing there).  The operand contract is ``kernels.ref.fused_mp_ref``'s,
except that the kernel walks the plan's CSR ``offsets`` where the plain
version reads ``ids_sorted``.  The wrapper takes CUDA tensors only, checks
device, dtype, shape and contiguity, sizes the kernel's dynamic shared
memory per spec, launches on the current stream and raises if the launch
fails.  ``launches`` counts the launches it made, ``int8_launches`` those
of them that ran the int8 gamma; a graph with no node launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

OP_BITS = {"sum": 1, "sqsum": 2, "max": 4, "min": 8, "wsum": 16}
PHI_CODES = {"copy": 0, "add_relu": 1}
GAMMA_CODES = {"gcn": 0, "gin": 1, "pna": 2, "dgn": 3}
# the accumulators each gamma reads
REQUIRED_OPS = {
    "gcn": ("sum",), "gin": ("sum",),
    "pna": ("sum", "sqsum", "max", "min"), "dgn": ("sum", "wsum"),
}
MAX_FEATURES = 256  # 32 lanes x 8 registers per destination warp
MAX_SMEM_BYTES = 232_448  # 227 KB of dynamic shared memory per block
TILE = 16  # destination nodes per block, as in csrc/fused_mp.cu

launches = 0
int8_launches = 0  # the launches among them with gamma's int8 linear

_SIGNATURES = {
    "fused_mp_launch": (
        ctypes.c_int,
        (ctypes.c_void_p,) * 15 + (ctypes.c_int,) * 11 + (ctypes.c_void_p,),
    ),
}


def _check(name, t, device, dtype, shape):
    _build.check("fused_mp", name, t, device, dtype, shape)


def smem_bytes(f: int, n_ops: int, k1: int, h1: int, int8: bool = False) -> int:
    """Dynamic shared memory one block of the kernel needs: a TILE x F
    table per accumulator, gamma's TILE x K1 input and TILE x H1 hidden
    layer, fp32, and for int8 TILE row scales and the TILE x K1 int8 tile
    (``csrc/fused_mp.cu`` sizes its launch the same way)."""
    f32 = 4 * TILE * (n_ops * f + k1 + h1)
    return f32 + 4 * TILE + TILE * k1 if int8 else f32


def fused_mp(
    spec,
    offsets: torch.Tensor,
    src_sorted: torch.Tensor,
    in_degree: torch.Tensor,
    node_mask: torch.Tensor,
    msrc: torch.Tensor,
    x_res: torch.Tensor,
    nop: torch.Tensor | None = None,
    eop: torch.Tensor | None = None,
    ew: torch.Tensor | None = None,
    w1: torch.Tensor | None = None,
    b1: torch.Tensor | None = None,
    w1_scale: torch.Tensor | None = None,
    w2: torch.Tensor | None = None,
    b2: torch.Tensor | None = None,
) -> torch.Tensor:
    """One fused message-passing layer on CUDA tensors -> (N, F_out)."""
    global launches, int8_launches
    dev = msrc.device
    if dev.type != "cuda":
        raise ValueError(f"fused_mp kernel needs CUDA tensors, got {dev}")
    missing = [op for op in REQUIRED_OPS[spec.gamma] if op not in spec.ops]
    if missing:
        raise ValueError(f"fused_mp: gamma {spec.gamma!r} needs ops {missing}")
    n = in_degree.shape[0]
    e = src_sorted.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("msrc", msrc, dev, f32, (n, None))
    f = msrc.shape[1]
    if not 0 < f <= MAX_FEATURES:
        raise ValueError(f"fused_mp: F={f} outside (0, {MAX_FEATURES}]")
    _check("offsets", offsets, dev, i32, (n + 1,))
    _check("src_sorted", src_sorted, dev, i32, (e,))
    _check("in_degree", in_degree, dev, i32, (n,))
    _check("node_mask", node_mask, dev, torch.bool, (n,))
    _check("x_res", x_res, dev, f32, (n, f))
    fr = f
    if spec.phi == "add_relu":
        _check("eop", eop, dev, f32, (e, f))
    if "wsum" in spec.ops:
        if ew is not None and ew.dim() == 2:
            ew = ew.reshape(-1)
        _check("ew", ew, dev, f32, (e,))
    k1 = h1 = 0
    p = 0
    int8 = spec.precision == "int8" and spec.gamma != "gcn"
    w1_dtype = torch.int8 if int8 else f32
    if spec.gamma == "gcn":
        _check("nop", nop, dev, f32, (n, None))
        f_out = fr
    elif spec.gamma == "gin":
        _check("w1", w1, dev, w1_dtype, (f, None))
        k1, h1 = f, w1.shape[1]
        _check("b1", b1, dev, f32, (h1,))
        _check("w2", w2, dev, f32, (h1, None))
        f_out = w2.shape[1]
        _check("b2", b2, dev, f32, (f_out,))
    else:
        k1 = 12 * f if spec.gamma == "pna" else 3 * f
        _check("nop", nop, dev, f32, (n, 3 if spec.gamma == "pna" else 1))
        _check("w1", w1, dev, w1_dtype, (k1, fr))
        f_out = fr
        _check("b1", b1, dev, f32, (f_out,))
    if int8:
        _check("w1_scale", w1_scale, dev, f32, (w1.shape[1],))
    if nop is not None and spec.gamma != "gin":
        p = nop.shape[1]
    ops = set(spec.ops)
    ops_bits = sum(OP_BITS[op] for op in ops)
    smem = smem_bytes(f, len(ops), k1, h1, int8)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_mp: spec {spec} at F={f} needs {smem} bytes of shared "
            f"memory per block, more than {MAX_SMEM_BYTES}"
        )
    out = torch.empty((n, f_out), dtype=f32, device=dev)
    if n == 0:
        return out
    lib = _build.load("fused_mp", _SIGNATURES)
    ptr = lambda t: None if t is None else t.data_ptr()
    uses_nop = spec.gamma != "gin"
    with _build.device_scope(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_mp_launch(
            offsets.data_ptr(), src_sorted.data_ptr(), msrc.data_ptr(),
            x_res.data_ptr(), ptr(nop) if uses_nop else None,
            ptr(eop) if spec.phi == "add_relu" else None,
            ptr(ew) if "wsum" in spec.ops else None,
            in_degree.data_ptr(), node_mask.data_ptr(),
            ptr(w1) if spec.gamma != "gcn" else None,
            ptr(b1) if spec.gamma != "gcn" else None,
            ptr(w1_scale) if int8 else None,
            ptr(w2) if spec.gamma == "gin" else None,
            ptr(b2) if spec.gamma == "gin" else None,
            out.data_ptr(),
            n, f, fr, p, k1, h1, f_out,
            PHI_CODES[spec.phi], ops_bits, GAMMA_CODES[spec.gamma], int(int8),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mp launch failed: cudaError_t {err}")
    launches += 1
    int8_launches += int8
    return out
