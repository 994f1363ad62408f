"""Dispatching wrappers over the port's CUDA kernels (port of
``repro.kernels.ops``).

``mode``:

  * "auto":      the CUDA kernel for CUDA tensors, the plain PyTorch
                 version (``kernels/ref.py``) for CPU tensors;
  * "kernel":    the CUDA kernel; raises for CPU tensors;
  * "reference": the plain version on any device — the explicit request
                 ``chip_smoke.py`` uses to build the values it compares
                 the kernels against.

The ``REPRO_KERNEL_MODE`` environment variable, when set, overrides the
per-call ``mode``, as in the JAX package.  There is no fallback: on a CUDA
tensor the kernel launches or raises, and a kernel that fails to build
raises.  The TPU package's VMEM-budget fallback has no counterpart here.

Every decision is counted in the process-wide registry as
``kernels_dispatch_total{op, path}`` (path ``kernel`` or ``reference``),
as JAX's ``_record_dispatch`` counts it.  JAX counts at trace time, once
per (program, signature) it compiles; the port counts where the wrapper
runs, and the executor mutes every forward but one per such key
(:func:`census_muted`): on the card the one recorded into the CUDA graph,
on the CPU the warm forward.  So the census counts the programs built, not
the requests served, as JAX's does.  The wrappers' launch counters are
not muted: they count every launch.

Where a gradient is needed (grad enabled and an operand requiring it) a
kernel runs inside an autograd Function whose backward is its plain
version's: :class:`KernelFunction` for the GNN kernels,
:class:`FlashAttention` for attention.  Elsewhere (serving, its CUDA
graphs) the kernel's wrapper is called bare.

The fp32 kernels refuse other dtypes.  Where a plain version reads an
operand in fp32 (``.float()``), the dispatch hands its kernel that fp32
tensor, and ``node_mlp`` casts the kernel's output to the input's dtype
as ``node_mlp_ref`` does: an f16 or integer node-feature stream serves on
the card as on the CPU.  ``.float()`` of an fp32 tensor is the tensor
itself, so fp32 pays nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import os

import torch

from repro_torch.kernels import edge_softmax as _edge_softmax_kernel
from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import fused_mp as _fused_mp_kernel
from repro_torch.kernels import node_mlp as _node_mlp_kernel
from repro_torch.kernels import quant_mlp as _quant_mlp_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import segment_reduce as _segment_kernel
from repro_torch.obs.metrics import default_registry

MODES = ("auto", "kernel", "reference")

# depth of the census_muted() blocks open in this thread (a new thread
# starts with an empty context, so at 0)
_muted = contextvars.ContextVar("census_muted", default=0)


@contextlib.contextmanager
def census_muted():
    """Within the block no wrapper called on this thread records its
    dispatch decision: the executor runs a program's forward several times
    (the eager warm, the capture, each CPU run) and counts one of them.
    Wrappers on other threads are counted as usual."""
    token = _muted.set(_muted.get() + 1)
    try:
        yield
    finally:
        _muted.reset(token)


def _record_dispatch(op: str, use_kernel: bool) -> None:
    """Count one dispatch decision in the process-wide registry
    (``kernels_dispatch_total{op, path}``) unless :func:`census_muted`: a
    dict update, nothing staged on the device."""
    if _muted.get():
        return
    default_registry().counter("kernels_dispatch_total").inc(
        op=op, path="kernel" if use_kernel else "reference")


def _resolve(op: str, mode: str, t: torch.Tensor) -> bool:
    """-> whether the CUDA kernel runs ``op`` for tensor ``t``; the
    decision is counted (:func:`_record_dispatch`)."""
    env = os.environ.get("REPRO_KERNEL_MODE", "")
    if env:
        if env not in MODES:
            raise ValueError(
                f"REPRO_KERNEL_MODE={env!r} invalid; expected one of {MODES}"
            )
        mode = env
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; expected one of {MODES}")
    on_cuda = mode != "reference" and t.device.type == "cuda"
    if mode == "kernel" and not on_cuda:
        raise RuntimeError(
            f"kernel mode needs CUDA tensors; got a tensor on {t.device} "
            "(the CUDA kernels have no CPU or interpret mode)"
        )
    _record_dispatch(op, on_cuda)
    return on_cuda


def _launch(kernel, plain, *operands):
    """``kernel(*operands)``, the CUDA kernel's call; where a gradient is
    needed (grad enabled and a tensor operand requiring it) inside
    :class:`KernelFunction`, whose backward is ``plain``'s.  Serving (no
    grad, ``torch.inference_mode``, a capture) calls the kernel bare."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in operands):
        return KernelFunction.apply(kernel, plain, *operands)
    return kernel(*operands)


class KernelFunction(torch.autograd.Function):
    """A GNN kernel with a gradient: the forward is the CUDA kernel
    (``kernel``, a fresh output with no history of its own), the backward
    the gradient of its plain version (``plain``, ``kernels/ref.py``)
    recomputed on the saved operands, as JAX trains through autodiff of its
    jnp reference off the TPU and has no Pallas backward.  ``operands`` are
    tensors or None; the gradient of each that requires one is the plain
    version's, in its dtype (a tie of ``max`` / ``min`` shares it as
    ``scatter_reduce`` does, ``torch.round`` passes none).  The recompute
    calls ``kernels/ref.py`` directly, so it is no dispatch and no launch."""

    @staticmethod
    def forward(ctx, kernel, plain, *operands):
        ctx.plain = plain
        ctx.save_for_backward(*operands)
        return kernel(*operands)

    @staticmethod
    def backward(ctx, grad):
        wants = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, wants)]
            wrt = [t for t, w in zip(inputs, wants) if w]
            grads = iter(torch.autograd.grad(ctx.plain(*inputs), wrt, grad,
                                             allow_unused=True))
        return (None, None, *(next(grads) if w else None for w in wants))


def segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    offsets: torch.Tensor,
    num_segments: int,
    op: str = "sum",
    mode: str = "auto",
    perm: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sorted-segment reduction (the MP PE): values (E, F) -> (N, F).

    ``segment_ids`` and ``offsets`` come from one ``core.layout``
    plan: the CUDA kernel walks the CSR ``offsets``, the plain version
    reads the ids.  ``perm`` (the plan's permutation) gathers COO-order
    ``values`` into plan order first.
    """
    if perm is not None:
        values = values[perm.long()]
    plain = lambda v, ids: ref.segment_reduce_sorted_ref(v, ids, num_segments, op)
    if not _resolve("segment_reduce", mode, values):
        return plain(values, segment_ids)
    kernel = lambda v, ids: _segment_kernel.segment_reduce(
        v.float().contiguous(), offsets.contiguous(), num_segments, op)
    return _launch(kernel, plain, values, segment_ids)


def edge_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    offsets: torch.Tensor,
    num_segments: int,
    mode: str = "auto",
    perm: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-destination softmax over sorted edges (GAT): (E, H) -> (E, H).

    Plan operands as for :func:`segment_reduce`; ``perm`` gathers
    COO-order ``logits`` into plan order first.
    """
    if perm is not None:
        logits = logits[perm.long()]
    plain = lambda z, ids: ref.edge_softmax_ref(z, ids, num_segments)
    if not _resolve("edge_softmax", mode, logits):
        return plain(logits, segment_ids)
    kernel = lambda z, ids: _edge_softmax_kernel.edge_softmax(
        z.float().contiguous(), offsets.contiguous(), num_segments)
    return _launch(kernel, plain, logits, segment_ids)


def node_mlp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             activation: str = "relu", mode: str = "auto") -> torch.Tensor:
    """Fused linear + bias + activation (the NE PE)."""
    plain = lambda x, w, b: ref.node_mlp_ref(x, w, b, activation)
    if not _resolve("node_mlp", mode, x):
        return plain(x, w, b)
    kernel = lambda x, w, b: _node_mlp_kernel.node_mlp(
        x.float().contiguous(), w.contiguous(), b.contiguous(), activation).to(x.dtype)
    return _launch(kernel, plain, x, w, b)


def quant_node_mlp(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                   b: torch.Tensor, activation: str = "relu",
                   row_scale: torch.Tensor | None = None,
                   mode: str = "auto") -> torch.Tensor:
    """Quantized NE PE: int8 x int8 -> int32, then
    ``act((acc * scale) * row_scale + b)``; ``scale`` is (N,) or ()."""
    plain = lambda x_q, w_q, scale, b, rs: ref.quant_node_mlp_ref(
        x_q, w_q, scale, b, activation, rs)
    if not _resolve("quant_node_mlp", mode, x_q):
        return plain(x_q, w_q, scale, b, row_scale)
    c = lambda t: None if t is None else t.contiguous()
    kernel = lambda x_q, w_q, scale, b, rs: _quant_mlp_kernel.quant_node_mlp(
        c(x_q), c(w_q), c(scale.float()), c(b.float()), activation, c(rs))
    return _launch(kernel, plain, x_q, w_q, scale, b, row_scale)


def quant_node_mlp_dynamic(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                           b: torch.Tensor, activation: str = "none",
                           mode: str = "auto") -> torch.Tensor:
    """The int8-dynamic linear in one call: rows of ``x`` quantized to int8
    at their exact-range scales, then the quantized NE PE with those row
    scales; ``w_scale`` is (N,) or ()."""
    plain = lambda x, w_q, w_scale, b: ref.quant_node_mlp_dynamic_ref(
        x, w_q, w_scale, b, activation)
    if not _resolve("quant_node_mlp", mode, x):
        return plain(x, w_q, w_scale, b)
    kernel = lambda x, w_q, w_scale, b: _quant_mlp_kernel.quant_node_mlp_dynamic(
        x.float().contiguous(), w_q.contiguous(), w_scale.float().contiguous(),
        b.float().contiguous(), activation)
    return _launch(kernel, plain, x, w_q, w_scale, b)


def fused_mp(
    spec,
    ids_sorted: torch.Tensor,
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
    mode: str = "auto",
) -> torch.Tensor:
    """One fused (phi, A, gamma) message-passing layer (the megakernel).

    Operands follow ``kernels.ref.fused_mp_ref``, plus the plan's CSR
    ``offsets`` (``core.layout.GraphLayout.offsets``): the CUDA kernel
    walks those ranges, the plain version reads ``ids_sorted``.  ``msrc``
    may have more rows than the destinations (a shard's all-gathered
    source table); ``src_sorted`` indexes it.
    """
    operands = dict(locals())  # the tensor operands, in the signature's order
    del operands["spec"], operands["mode"]
    names = tuple(operands)

    def plain(*ts):
        o = dict(zip(names, ts))
        del o["offsets"]
        return ref.fused_mp_ref(spec, **o)

    if not _resolve("fused_mp", mode, msrc):
        return plain(*operands.values())

    def kernel(*ts):
        o = {k: None if t is None else t.contiguous() for k, t in zip(names, ts)}
        for k in ("msrc", "x_res", "eop"):
            o[k] = None if o[k] is None else o[k].float()
        del o["ids_sorted"]
        return _fused_mp_kernel.fused_mp(spec, **o)

    return _launch(kernel, plain, *operands.values())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    mode: str = "auto", softcap: float = 0.0) -> torch.Tensor:
    """Blockwise GQA attention: q (B, Hq, S, D), k (B, Hkv, S, D), v (B,
    Hkv, S, Dv) -> (B, Hq, S, Dv), scaled by 1 / sqrt(D).  The CUDA kernel
    takes strided views (unit feature stride) and the head dims it has an
    instance for (``flash_attention.has_instance``); the plain version is
    the quadratic oracle.

    Where a gradient is needed (grad enabled and q, k or v requiring it),
    the kernel runs inside :class:`FlashAttention`, whose backward is the
    plain ``ref.flash_attention_bwd_ref``; elsewhere (serving, its CUDA
    graphs) the wrapper is called as it is.

    DTensor operands (a mesh's train step) run on each rank's own block
    (:func:`_flash_sharded`): the same kernel, or the same plain version,
    on the rank's (batch, head) block, and the dispatch is counted once a
    rank."""
    if _is_dtensor(q):
        return _flash_sharded(q, k, v, causal, window, mode, softcap)
    if not _resolve("flash_attention", mode, q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _flash_kernel.flash_attention(q, k, v, causal=causal, window=window,
                                         softcap=softcap)


class FlashAttention(torch.autograd.Function):
    """The flash kernel with a gradient: the forward is the CUDA kernel (its
    route chosen as for any call), the backward the plain
    ``ref.flash_attention_bwd_ref`` on the saved q, k and v, as JAX trains
    through autodiff of its jnp attention and has no Pallas backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.band = (causal, window, softcap)
        return _flash_kernel.flash_attention(q, k, v, causal=causal, window=window,
                                             softcap=softcap)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        causal, window, softcap = ctx.band
        dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                                 window=window, softcap=softcap)
        return dq, dk, dv, None, None, None


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _block(placements, dim: int, mesh) -> tuple:
    """(this rank's block, the number of blocks) of tensor dim ``dim`` under
    ``placements`` (mesh dims major to minor)."""
    from torch.distributed.tensor import Shard

    idx, count = 0, 1
    for i, pl in enumerate(placements):
        if pl == Shard(dim):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
            count *= mesh.size(i)
    return idx, count


def _flash_sharded(q, k, v, causal, window, mode, softcap):
    """:func:`flash_attention` on DTensors (B, H, S, D) under
    ``local_map``: each rank attends its own block of q, a block of the
    batch (dim 0) and of the heads (dim 1), over the kv heads of its q heads'
    groups, with the kernel (or the plain version) and its backward on
    local tensors; no library attention takes its place.

    k and v follow q's batch cut.  Where q's heads are cut and the kv
    heads divide as well, each rank holds the kv heads of its q heads (the
    GQA groups are contiguous); where the kv heads stay whole on a mesh dim
    that cuts q's heads, the rank picks its groups' kv heads out of the
    whole ones, and their gradient is partial there (every rank adds its
    heads' share)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    hq, hkv = q.shape[1], k.shape[1]
    # q keeps its cuts of the batch and the heads; any other cut or partial
    # sum is made whole first
    qp = tuple(pl if pl in (Shard(0), Shard(1)) else Replicate() for pl in q.placements)
    q = q.redistribute(placements=qp)
    kv_cut = hkv % _block(qp, 1, mesh)[1] == 0
    kvp = tuple(Replicate() if pl == Shard(1) and not kv_cut else pl for pl in qp)
    k, v = (t.redistribute(placements=kvp) for t in (k, v))
    grad_kvp = tuple(Partial() if pl != kv else kv for pl, kv in zip(qp, kvp))
    g = hq // hkv

    def body(ql, kl, vl):
        hl = ql.shape[1]
        h0 = _block(qp, 1, mesh)[0] * hl
        k0 = _block(kvp, 1, mesh)[0] * kl.shape[1]
        # the kv head of each q head, in Python integers: nothing is read
        # back from a tensor (a fake tensor has no values)
        need = [h // g - k0 for h in range(h0, h0 + hl)]
        first, last = need[0], need[-1] + 1
        if last - first != kl.shape[1]:
            rep = hl // (last - first)
            if hl % (last - first) == 0 and need == [first + i // rep for i in range(hl)]:
                kl, vl = kl[:, first:last], vl[:, first:last]
            else:  # groups cut across ranks: one kv head for each q head
                kl, vl = kl[:, need], vl[:, need]
        return flash_attention(ql, kl, vl, causal=causal, window=window, mode=mode,
                               softcap=softcap)

    return local_map(body, out_placements=list(qp), in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, grad_kvp, grad_kvp),
                     device_mesh=mesh)(q, k, v)
