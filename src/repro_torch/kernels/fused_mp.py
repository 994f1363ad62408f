"""Wrapper of the ``fused_mp`` CUDA kernel (``csrc/fused_mp.cu``): one whole
(phi, A, gamma) message-passing layer in one pass over the CSR plan.

Port of ``repro.kernels.fused_mp.fused_mp``: all four gammas (gcn, gin,
pna, dgn), all five accumulators (sum, sqsum, max, min, wsum), and both
precisions — under ``spec.precision="int8"`` gamma's first linear takes
int8 ``w1`` with per-column f32 ``w1_scale`` and quantizes its input per
row inside the pass (gcn's gamma has no linear, so precision changes
nothing there).  The operand contract is ``kernels.ref.fused_mp_ref``'s,
except that the kernel walks the plan's CSR ``offsets`` where the plain
version reads ``ids_sorted``.  The source table ``msrc`` has its own row
count N_src: the graph's N on one rank, every rank's rows on a shard of a
mesh (``core.message_passing.source_rows``), with ``src_sorted`` values
below N_src (a contract the wrapper cannot check without reading the plan
back); ``x_res``, ``nop`` and the output are the destination rows.  The
wrapper takes CUDA tensors only, checks
device, dtype, shape and contiguity, sizes the kernel's dynamic shared
memory per spec, launches on the current stream and raises if the launch
fails.  ``launches`` counts the launches it made, ``int8_launches`` those
of them that ran the int8 gamma; a graph with no node launches nothing.

A block owns ``rows_for(...)`` destinations (32 where gamma has a linear
and 32 rows' shared memory fits ``MAX_SMEM_BYTES``, else 16); the kernel
picks the same with the same function of the spec, and :func:`smem_bytes`
mirrors its shared-memory layout.  :func:`launch_args` checks a layer's
operands and :func:`launch` launches it; :func:`fused_mp` does both and
counts the launch.
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
ROWS = (32, 16)  # destinations per block (rows_for)
# 32-bit words of one staged fp32 weight slice of gamma's products (an int8
# slice takes half); two slices are staged at a time, as in csrc/fused_mp.cu
STAGE_WORDS = 4096

# counts the wrapper's calls that launch: eager launches and those a
# CUDA-graph capture records (the executor's warm); a replay runs no
# wrapper and is not counted here
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


def smem_bytes(f: int, n_ops: int, k1: int, h1: int, int8: bool = False,
               rows: int | None = None) -> int:
    """Dynamic shared memory one block of ``rows`` destinations (by default
    ``rows_for`` the spec) needs: a
    rows x F fp32 table per accumulator; gamma's input (K1 deep) and GIN's
    hidden layer (H1 deep), k-major at rows + 4 words a k; for int8 the row
    scales and the int8 tile (four k to a word, rows + 4 words a word); and
    two staged weight slices, fp32 or (when every product of gamma is int8)
    int8 (``csrc/fused_mp.cu:smem_bytes``)."""
    if rows is None:
        rows = rows_for(f, n_ops, k1, h1, int8)
    pr = rows + 4
    words = rows * n_ops * f + pr * (k1 + h1)
    if int8:
        words += rows + pr * ((k1 + 3) // 4)
    if k1 > 0:
        words += STAGE_WORDS if int8 and h1 == 0 else 2 * STAGE_WORDS
    return 4 * words


def rows_for(f: int, n_ops: int, k1: int, h1: int, int8: bool = False) -> int:
    """Destinations per block for a spec (``csrc/fused_mp.cu:rows_for``):
    16 for a gamma with no linear (GCN), whose tile gains nothing from more
    rows and whose walk would run twice as many destinations a warp; else
    the first of ``ROWS`` whose shared memory fits."""
    if k1 == 0:
        return ROWS[-1]
    return next((r for r in ROWS if smem_bytes(f, n_ops, k1, h1, int8, r)
                 <= MAX_SMEM_BYTES), ROWS[-1])


def launch_args(
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
):
    """Check one layer's operands (CUDA tensors, :func:`fused_mp`'s
    contract) and allocate its output: ``(out, int8, args)``, ``int8``
    whether gamma runs its int8 linear and ``args`` the arguments of the C
    entry point ``fused_mp_launch`` but the stream.  Raises for an operand
    that breaks the contract, F past ``MAX_FEATURES`` or a block past
    ``MAX_SMEM_BYTES``."""
    dev = msrc.device
    if dev.type != "cuda":
        raise ValueError(f"fused_mp kernel needs CUDA tensors, got {dev}")
    missing = [op for op in REQUIRED_OPS[spec.gamma] if op not in spec.ops]
    if missing:
        raise ValueError(f"fused_mp: gamma {spec.gamma!r} needs ops {missing}")
    n = in_degree.shape[0]
    e = src_sorted.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("msrc", msrc, dev, f32, (None, None))  # (N_src, F)
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
    ptr = lambda t: None if t is None else t.data_ptr()
    uses_nop = spec.gamma != "gin"
    args = (
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
    )
    return out, int8, args


def launch(lib, out: torch.Tensor, args: tuple) -> None:
    """Launch ``fused_mp_launch`` of the loaded library ``lib`` with
    :func:`launch_args`' ``args`` on the current stream of ``out``'s
    device; raises if the launch fails.  Counts nothing."""
    with _build.device_scope(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.fused_mp_launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"fused_mp launch failed: cudaError_t {err}")


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
    out, int8, args = launch_args(spec, offsets, src_sorted, in_degree, node_mask,
                                  msrc, x_res, nop, eop, ew, w1, b1, w1_scale, w2, b2)
    if out.shape[0] == 0:
        return out
    launch(_build.load("fused_mp", _SIGNATURES), out, args)
    launches += 1
    int8_launches += int8
    return out
